"""sub3 through ops/synthvoice.py on the CPU: the plain version of kernels
10 and 11, the generator's route and the wrappers' checks.

* The plain version (stage 10, the CPU ``linear_recurrence_2``, stage 11)
  renders bit for bit as the generic path (sub3's own ``render`` with the
  generator's gain, pan and voice sum; the description taken off), over 4
  blocks with state carried: the synth cell's modulation patch under dense
  steals (K = 8 trigger slots), each LFO waveform, envelope and
  keytracking sources, no modulation, glide, per-note automation, two
  lanes, a mono output.
* The description routes sub3 to kernels 10, 2 and 11 on CUDA tensors (the
  launches monkeypatched) and to the plain version on CPU tensors; the
  host arrays kernel 10 is handed describe the block (a stand-in library).
* organ, dx7, a user's SynthDef and sub3 with its ``render`` replaced never
  reach ops/synthvoice.
* The wrappers raise on a wrong device, dtype, shape or a non-contiguous
  operand before the kernels are built.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import phonic_tpu_torch as pt
from phonic_tpu_torch import kernels
from phonic_tpu_torch.generators import synth as psynth
from phonic_tpu_torch.modulation.config import LFO_WAVEFORMS
from phonic_tpu_torch.ops import filters, scan, synthvoice
from phonic_tpu_torch.parallel.mesh import BatchedRenderProgram

SR = 48000
N = 4096
VOICES = 8
BLOCKS = 4
CELL = dict(sources="cell", wave="Sine")


def _modulation(sources, wave):
    if sources == "cell":  # the synth cell's patch (portbench synth_64v)
        return ((pt.LfoSource("LFO1", rate=2.0, waveform=wave),
                 pt.EnvelopeSource("ENV2", attack=0.005, decay=0.4,
                                   sustain=0.2, release=0.3),
                 pt.VelocitySource()),
                (("LFO1", "CUTF", 0.3, True), ("VELM", "CUTF", 0.4, False),
                 ("ENV2", "SHAP", 0.5, False)))
    if sources == "lfo":
        return ((pt.LfoSource("LFO1", rate=9.0, waveform=wave),),
                (("LFO1", "CUTF", 0.5, True), ("LFO1", "SHAP", 0.6, False)))
    return ((pt.EnvelopeSource("ENV1", attack=0.01, hold=0.02, decay=0.1,
                               sustain=0.5, release=0.1),
             pt.KeytrackingSource()),
            (("ENV1", "CUTF", 0.8, True), ("KEYM", "SHAP", 1.5, False),
             ("KEYM", "CUTF", 0.5, True)))


def _program(synth, sources="cell", wave="Sine", glide=0.0, auto=False,
             channels=2, lane=0, voices=VOICES):
    """A generator of ``synth`` with a dense note part over BLOCKS blocks:
    40 notes a block, most short, so voices start up to 8 notes a block and
    are stolen; knob turns on the cutoff, resonance, volume and pan."""
    gen = pt.SynthGenerator(synth, pt.GeneratorPlaybackOptions(
        voices=voices, volume=0.5), release_secs=0.002, glide_secs=glide,
        name="synth")
    if sources is not None:
        srcs, routes = _modulation(sources, wave)
        gen.with_modulation(pt.ModulationConfig(sources=srcs,
                                                targets=("CUTF", "SHAP")))
        for route in routes:
            gen.set_modulation(*route)
    main = pt.Mixer("main")
    main.add_source(gen)
    prog = pt.RenderProgram(main, pt.EngineConfig(
        sample_rate=SR, channels=channels, block_frames=N, device="cpu"))
    rng = np.random.default_rng(7 + lane)
    for b in range(BLOCKS):
        for t in b * N + np.sort(rng.integers(0, N, 40)):
            t = int(t)
            nid = gen.note_on(int(rng.integers(36, 85)),
                              float(rng.uniform(0.3, 1.0)),
                              float(rng.uniform(-0.5, 0.5)), time=t)
            gen.note_off(nid, time=t + int(rng.integers(100, 3000)))
            if auto and rng.random() < 0.5:
                gen.set_note_volume(nid, float(rng.uniform(0.2, 1.0)),
                                    time=t + int(rng.integers(0, 300)))
                gen.set_note_panning(nid, float(rng.uniform(-1.0, 1.0)),
                                     time=t + int(rng.integers(0, 300)))
                gen.set_note_speed(nid, float(rng.uniform(0.7, 1.5)),
                                   glide=12.0,
                                   time=t + int(rng.integers(0, 300)))
        for pid, lo, hi in (("CUTF", 300.0, 8000.0), ("RESO", 0.1, 0.8),
                            ("SVOL", 0.25, 0.75), ("SPAN", -0.8, 0.8)):
            if any(q.id == pid for q in gen.PARAMS):
                prog.set_parameter(gen, pid, float(rng.uniform(lo, hi)),
                                   at_frame=b * N + int(rng.integers(0, N)))
    return prog, gen


def _render(synth, lanes=1, **kw):
    """BLOCKS blocks with state carried: (audio per block, the generator's
    state after them, the most trigger slots a block lowered)."""
    progs = [_program(synth, lane=lane, **kw) for lane in range(lanes)]
    if lanes == 1:
        prog = progs[0][0]
        step, state = prog.step, prog.init_state()
        inputs = prog.block_inputs
    else:
        batched = BatchedRenderProgram(progs[0][0], lanes=lanes)
        step, state = batched.step, batched.init_states()
        inputs = lambda b: [p.block_inputs(b) for p, _ in progs]  # noqa: E731
    audio, most = [], 0
    for b in range(BLOCKS):
        ins = inputs(b)
        for i in ins if lanes > 1 else [ins]:
            most = max(most, i["extra"]["main/synth"]["_trig_time"].shape[1])
        state, out = step(state, ins)
        audio.append(out.numpy())
    return audio, state, most


def _generic(synth):
    """``synth`` with its kernel description taken off."""
    return dataclasses.replace(synth, kernel=None)


STAGED = ([("cell", CELL)]
          + [(f"lfo-{w.lower().replace(' ', '-')}",
              dict(sources="lfo", wave=w)) for w in LFO_WAVEFORMS]
          + [("envelope-keytrack", dict(sources="env-key")),
             ("no-modulation", dict(sources=None)),
             ("glide", dict(CELL, glide=0.03)),
             ("automation", dict(CELL, auto=True)),
             ("lanes2", dict(CELL, lanes=2)),
             ("mono", dict(CELL, channels=1))])


@pytest.mark.parametrize("kw", [c[1] for c in STAGED],
                         ids=[c[0] for c in STAGED])
def test_plain_version_equals_generic_path(kw):
    got, got_state, most = _render(pt.synths.sub3(), **kw)
    want, want_state, _ = _render(_generic(pt.synths.sub3()), **kw)
    assert most == 8
    for b, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"block {b}")
    assert np.abs(want[-1]).max() > 0.01
    flat = lambda s: [t for t in _leaves(s)]  # noqa: E731
    for g, w in zip(flat(got_state), flat(want_state)):
        assert torch.equal(g, w)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _captured(synth=None, **kw):
    """The arguments of the generator's ``render_lanes`` in block 1 of a CPU
    render, and the generator."""
    prog, gen = _program(synth or pt.synths.sub3(), **kw)
    seen = []
    routed = psynth.SynthGenerator.render_lanes

    def spy(self, *args):
        seen.append(args)
        return routed(self, *args)

    psynth.SynthGenerator.render_lanes = spy
    try:
        state = prog.init_state()
        for b in range(2):
            state, _ = prog.step(state, prog.block_inputs(b))
    finally:
        psynth.SynthGenerator.render_lanes = routed
    return gen, seen[-1]


def _fake_cuda(monkeypatch):
    """CPU tensors that claim to be CUDA ones, on a stream of handle 0."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    monkeypatch.setattr(kernels, "stream_handle", lambda t: 0)


def test_routes_by_device(monkeypatch):
    """CPU tensors take the plain version; CUDA tensors (CPU tensors that
    claim to be) launch kernel 10, iir2 and kernel 11 in turn."""
    calls = []

    def refuse(*args, **kw):
        raise AssertionError("the kernels were asked for CPU tensors")

    for name in ("voice_kernel", "mix_kernel", "iir2"):
        monkeypatch.setattr(synthvoice, name, refuse)
    gen, args = _captured()
    monkeypatch.undo()
    plain = []
    render_plain = synthvoice.render_plain
    monkeypatch.setattr(synthvoice, "render_plain",
                        lambda *a: plain.append(1) or render_plain(*a))
    gen.render_lanes(*args)
    assert plain == [1]
    monkeypatch.undo()

    state, params, inputs, live, frame0, ctx = args
    rows, n = VOICES, ctx.block_frames

    def voice_kernel(voice, phase0, p, slots, mod, *rest):
        calls.append("synth_voice")
        assert voice is gen.synth.kernel
        assert phase0.shape == (rows, 3) and slots.time.shape[0] == rows
        assert all(p[k].shape == (1, n) for k in p)
        assert mod.kinds == (0, 1, 2) and mod.salts == (0x11, 0, 0)
        return synthvoice.KernelVoices(torch.zeros(6, rows, n),
                                       torch.zeros(2, rows, n),
                                       torch.zeros(rows, 3))

    def iir2(*ops):
        calls.append("iir2")
        assert len(ops) == 8 and ops[0].shape == (rows, n)
        return torch.zeros(rows, n), torch.zeros(rows, n)

    def mix_kernel(s1, s2, svf, gains, lanes, channels):
        calls.append("synth_mix")
        assert (lanes, channels) == (1, 2) and gains.shape == (2, rows, n)
        return (filters.TptState(torch.zeros(rows), torch.zeros(rows)),
                torch.zeros(lanes, channels, n))

    monkeypatch.setattr(synthvoice, "voice_kernel", voice_kernel)
    monkeypatch.setattr(synthvoice, "iir2", iir2)
    monkeypatch.setattr(synthvoice, "mix_kernel", mix_kernel)
    monkeypatch.setattr(synthvoice, "render_plain", lambda *a: 1 / 0)
    _fake_cuda(monkeypatch)
    new, audio = gen.render_lanes(*args)
    assert calls == ["synth_voice", "iir2", "synth_mix"]
    assert audio.shape == (1, 2, n)
    assert new["synth"]["phase"].shape == (1, rows, 3)


class _Library:
    """A stand-in for the kernel library: records each launch's host
    configuration and returns success."""

    def __init__(self):
        self.launches = []

    def phonic_synth_voice(self, *args):
        assert len(args) == len(kernels._SIGNATURES["phonic_synth_voice"][0])
        cfg_i = np.ctypeslib.as_array((ctypes.c_int * 35).from_address(
            args[1])).copy()
        cfg_f = np.ctypeslib.as_array((ctypes.c_float * 8).from_address(
            args[2])).copy()
        self.launches.append(("synth_voice", cfg_i, cfg_f, args))
        return 0

    def phonic_synth_mix(self, *args):
        assert len(args) == len(kernels._SIGNATURES["phonic_synth_mix"][0])
        self.launches.append(("synth_mix", args))
        return 0


@pytest.mark.parametrize("kw", [dict(CELL, glide=0.03, auto=True),
                                dict(sources="env-key", channels=1),
                                dict(sources=None)],
                         ids=["cell-glide-automation", "envelope-mono",
                              "no-modulation"])
def test_kernel_is_handed_the_block(kw, monkeypatch):
    """Kernel 10's host arrays lay out the block as csrc/synthvoice.cu
    reads them: the sizes, the flags, each source's kind, salt and
    polarity, the targets, the rates; kernel 11 gets the lanes, voices and
    gain streams."""
    gen, args = _captured(**kw)
    lib = _Library()
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(kernels, "library", lambda: lib)
    monkeypatch.setattr(synthvoice, "iir2", lambda *ops: (ops[4], ops[5]))
    gen.render_lanes(*args)
    (_, cfg_i, cfg_f, vargs), (_, margs) = lib.launches
    n, k = args[-1].block_frames, args[2]["_trig_time"].shape[-1]
    g = 1 if kw.get("channels") == 1 else 2
    assert cfg_i[:5].tolist() == [n, k, VOICES, 1, g]
    assert cfg_i[9:11].tolist() == [kw.get("auto", False),
                                    kw.get("glide", 0.0) > 0.0]
    sources = kw["sources"]
    if sources is None:
        assert cfg_i[5] == 0 and cfg_i[7:9].tolist() == [-1, -1]
        assert vargs[14:18] == (0, 0, 0, 0)
    else:
        kinds = [0, 1, 2] if sources == "cell" else [1, 3]
        s = len(kinds)
        # targets ("CUTF", "SHAP"): the shape is target 1, the cutoff 0
        assert cfg_i[5:9].tolist() == [s, 2, 1, 0]
        assert cfg_i[11:11 + s].tolist() == kinds
        assert cfg_i[19:19 + s].tolist() == [0x11 * (x == 0) for x in kinds]
        assert cfg_i[27:27 + s].tolist() == [int(x == 0) for x in kinds]
    assert vargs[7] == 0 if not kw.get("auto") else vargs[7] != 0
    assert cfg_f[0] == np.float32(1) / np.float32(SR)
    assert cfg_f[2] == SR / 2
    want = synthvoice._amp_params(SR, torch.device("cpu"),
                                  gen.synth.kernel.envelope)
    assert cfg_f[3:].tolist() == [float(x) for x in want[:5]]
    assert margs[9:14] == (1, VOICES, n, g, 1 if g == 1 else 2)


def _library_refused():
    raise AssertionError("the kernels were built")


def _voice_operands(rows=4, lanes=1, n=256, k=2):
    voice = pt.synths.sub3().kernel
    params = {pid: torch.zeros(lanes, n) for pid in (
        "SHAP", "DETN", "CUTF", "RESO", "SVOL", "SPAN")}
    slots = synthvoice.Slots(torch.zeros(rows, k, dtype=torch.int32),
                             torch.zeros(5, rows, k),
                             torch.zeros(rows, dtype=torch.int32),
                             torch.zeros(6, rows), None)
    return dict(voice=voice, phase0=torch.zeros(rows, 3), params=params,
                slots=slots, mod=None, sr=SR, glide_secs=0.0, channels=2,
                volume="SVOL", panning="SPAN")


def _mix_operands(rows=4, n=256):
    return dict(s1=torch.zeros(rows, n), s2=torch.zeros(rows, n),
                svf=filters.TptState(torch.zeros(rows), torch.zeros(rows)),
                gains=torch.zeros(2, rows, n), lanes=1, channels=2)


def _strided(t):
    return torch.stack([t, t], dim=-1)[..., 0]


BAD_VOICE = [
    ("phase-shape", lambda o: {"phase0": torch.zeros(4, 2)}, ValueError),
    ("phase-float64", lambda o: {"phase0": torch.zeros(4, 3,
                                                       dtype=torch.float64)},
     TypeError),
    ("phase-strided", lambda o: {"phase0": _strided(torch.zeros(4, 3))},
     ValueError),
    ("lanes", lambda o: {"params": {k: torch.zeros(3, 256)
                                    for k in o["params"]}}, ValueError),
    ("trigger-int64", lambda o: {"slots": o["slots"]._replace(
        time=torch.zeros(4, 2, dtype=torch.int64))}, TypeError),
    ("slots-shape", lambda o: {"slots": o["slots"]._replace(
        trig=torch.zeros(4, 4, 2))}, ValueError),
]
BAD_MIX = [
    ("gain-streams", lambda o: {"gains": torch.zeros(3, 4, 256)}, ValueError),
    ("state-float64", lambda o: {"s2": torch.zeros(4, 256,
                                                   dtype=torch.float64)},
     TypeError),
    ("svf-shape", lambda o: {"svf": filters.TptState(torch.zeros(3),
                                                     torch.zeros(4))},
     ValueError),
    ("strided", lambda o: {"s1": _strided(torch.zeros(4, 256))}, ValueError),
]


@pytest.mark.parametrize("wrapper", ["voice", "mix"])
def test_wrappers_refuse_cpu_tensors(wrapper, monkeypatch):
    monkeypatch.setattr(kernels, "library", _library_refused)
    with pytest.raises(ValueError, match="CUDA"):
        if wrapper == "voice":
            synthvoice.voice_kernel(**_voice_operands())
        else:
            synthvoice.mix_kernel(**_mix_operands())


@pytest.mark.parametrize("bad,exc", [(c[1], c[2]) for c in BAD_VOICE],
                         ids=[c[0] for c in BAD_VOICE])
def test_voice_wrapper_raises(bad, exc, monkeypatch):
    monkeypatch.setattr(kernels, "library", _library_refused)
    _fake_cuda(monkeypatch)
    ops = _voice_operands()
    ops.update(bad(ops))
    with pytest.raises(exc):
        synthvoice.voice_kernel(**ops)


@pytest.mark.parametrize("bad,exc", [(c[1], c[2]) for c in BAD_MIX],
                         ids=[c[0] for c in BAD_MIX])
def test_mix_wrapper_raises(bad, exc, monkeypatch):
    monkeypatch.setattr(kernels, "library", _library_refused)
    _fake_cuda(monkeypatch)
    ops = _mix_operands()
    ops.update(bad(ops))
    with pytest.raises(exc):
        synthvoice.mix_kernel(**ops)


def _user_synth():
    """A user's SynthDef: a plain sine with a filter, no description."""
    def init(ctx, batch):
        return {"phase": torch.zeros(batch, device=ctx.device),
                "svf": filters.tpt_state_init((batch,), device=ctx.device)}

    def render(state, ctx):
        from phonic_tpu_torch.ops import osc
        ph, end = osc.phase_accumulate(state["phase"], ctx.freq,
                                       ctx.sample_rate)
        coefs = filters.svf_coefficients(filters.LOWPASS, ctx.sample_rate,
                                         torch.full_like(ctx.freq, 900.0),
                                         torch.full_like(ctx.freq, 0.3))
        svf, y = filters.tpt_process(state["svf"], osc.sine(ph), coefs)
        return {"phase": end, "svf": svf}, y * ctx.gate

    return pt.SynthDef(init=init, render=render)


@pytest.mark.parametrize("make", [
    lambda: pt.synths.organ(), lambda: pt.synths.dx7(), _user_synth,
    lambda: dataclasses.replace(pt.synths.sub3(), render=_user_synth().render,
                                init=_user_synth().init)],
    ids=["organ", "dx7", "user", "sub3-render-replaced"])
def test_other_synthdefs_keep_their_render(make, monkeypatch):
    """SynthDefs without a description of their render never reach
    ops/synthvoice, on the CPU or with CUDA tensors."""
    def refuse(*args, **kw):
        raise AssertionError("reached ops/synthvoice")

    for name in ("render_plain", "render_kernels", "voice_kernel",
                 "mix_kernel", "slot_rows"):
        monkeypatch.setattr(synthvoice, name, refuse)
    synth = make()
    assert synth.kernel is None or not synth.kernel.describes(synth)
    gen, args = _captured(synth, sources=None)
    _fake_cuda(monkeypatch)
    monkeypatch.setattr(kernels, "library", _library_refused)
    # the generic path on tensors that claim the card reaches no kernel of
    # this module (a user's filter would launch iir2: not called here)
    monkeypatch.setattr(scan, "iir2", lambda *ops: scan.chunked_second(
        *ops))
    _, audio = gen.render_lanes(*args)
    assert audio.shape == (1, 2, N)
