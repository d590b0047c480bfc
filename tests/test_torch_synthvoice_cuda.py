"""Kernels 10 and 11 (``phonic_tpu_torch/csrc/synthvoice.cu``) around iir2
against the plain version (``ops/synthvoice.py``) on the card, through a
SynthGenerator playing sub3.

Needs a CUDA card and ``nvcc``; without them every test skips.  On the
card: ``python -m pytest --noconftest -m cuda
tests/test_torch_synthvoice_cuda.py -q``.

Each case renders 8 blocks of 131072 frames of a dense note part (40 notes
a block, most of them short, so voices start up to 8 notes a block and are
stolen) with knob turns on the cutoff, resonance, volume and pan.  At every
block the generator's render is taken apart: the same state and inputs
(the plain version's, carried over the blocks) go through kernel 10, iir2
and kernel 11, and through the plain version on the card.  The checks:

- iir2's six operands, the gain streams (the plain version's envelope,
  voice gain and pan factor multiplied in the kernel's order), the lane
  output and the new SVF state lie within -110 dB of the lane's RMS of the
  plain version's (the RMS of the difference over each lane's rows).  The
  kernels take every step in the plain version's order with the same CUDA
  math functions, so only three sums may round apart: the float64 phase
  sums (exact at these increments whatever their order), the voice sum
  (voice order against ``torch.sum``'s) and the gain (one factor per
  channel against three products in turn), each a few float32 ulps of a
  voice sample, -130 dB and below;
- the end phases within 1 float32 ulp;
- the generator's own render (routed by the device) equals the kernels'
  output, and launches each of kernel 10, iir2 and kernel 11 once a block.

Cases: each of the 7 LFO waveforms; an envelope and a keytracking source;
glide; per-note automation knots; a voice that starts 8 notes in a block;
a lane-batched program of 8 lanes.
"""

import numpy as np
import pytest
import torch

import phonic_tpu_torch as pt
from phonic_tpu_torch import tracing
from phonic_tpu_torch.generators import synth as psynth
from phonic_tpu_torch.generators.sampler import voice_rows
from phonic_tpu_torch.graph.engine import tree_map
from phonic_tpu_torch.modulation.config import LFO_WAVEFORMS
from phonic_tpu_torch.ops import filters, scan, synthvoice
from phonic_tpu_torch.parallel.mesh import BatchedRenderProgram

pytestmark = pytest.mark.cuda

SR = 48000
N = 131072
BLOCKS = 8
VOICES = 8
TOLERANCE_DB = -110.0
IDS = ("SHAP", "DETN", "CUTF", "RESO", psynth.VOLUME.id, psynth.PANNING.id)

# (id, LFO waveform, sources, glide seconds, automation, voices, lanes)
CASES = [(f"lfo-{w.lower().replace(' ', '-')}", w, "lfo", 0.0, False,
          VOICES, 1) for w in LFO_WAVEFORMS] + [
    ("envelope-keytrack", "Sine", "env-key", 0.0, False, VOICES, 1),
    ("glide", "Sine", "lfo", 0.05, False, VOICES, 1),
    ("automation", "Triangle", "lfo", 0.0, True, VOICES, 1),
    ("eight-starts", "Sine", "lfo", 0.02, False, 1, 1),
    ("lanes8", "Sine", "lfo", 0.0, False, VOICES, 8)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _generator(case):
    _, wave, kind, glide, _, voices, _ = case
    gen = pt.SynthGenerator(pt.synths.sub3(), pt.GeneratorPlaybackOptions(
        voices=voices, volume=0.5), release_secs=0.002, glide_secs=glide,
        name="synth")
    if kind == "lfo":
        sources = (pt.LfoSource("LFO1", rate=3.0, waveform=wave),
                   pt.EnvelopeSource("ENV2", attack=0.005, decay=0.4,
                                     sustain=0.2, release=0.3),
                   pt.VelocitySource())
        routes = (("LFO1", "CUTF", 0.3, True), ("VELM", "CUTF", 0.4, False),
                  ("ENV2", "SHAP", 0.5, False), ("LFO1", "SHAP", 0.4, False))
    else:
        sources = (pt.EnvelopeSource("ENV1", attack=0.01, hold=0.02,
                                     decay=0.1, sustain=0.5, release=0.1),
                   pt.KeytrackingSource())
        routes = (("ENV1", "CUTF", 0.8, True), ("KEYM", "SHAP", 1.5, False),
                  ("KEYM", "CUTF", 0.5, True))
    gen.with_modulation(pt.ModulationConfig(sources=sources,
                                            targets=("CUTF", "SHAP")))
    for route in routes:
        gen.set_modulation(*route)
    return gen


def _program(case, dev, lane=0):
    """The case's generator in a program on ``dev`` with its note part and
    knob turns over BLOCKS blocks, each lane its own."""
    gen = _generator(case)
    main = pt.Mixer("main")
    main.add_source(gen)
    prog = pt.RenderProgram(main, pt.EngineConfig(
        sample_rate=SR, block_frames=N, device=dev), device=dev)
    rng = np.random.default_rng(sum(map(ord, case[0])) + 1000 * lane)
    for b in range(BLOCKS):
        if case[0] == "eight-starts":
            starts = b * N + np.sort(rng.choice(N - 400, 8, replace=False))
        else:
            starts = b * N + np.sort(rng.integers(0, N, 40))
        for t in starts:
            t = int(t)
            nid = gen.note_on(int(rng.integers(36, 85)),
                              float(rng.uniform(0.3, 1.0)),
                              float(rng.uniform(-0.5, 0.5)), time=t)
            gen.note_off(nid, time=t + int(rng.integers(200, 30000)))
            if case[4] and rng.random() < 0.5:
                gen.set_note_volume(nid, float(rng.uniform(0.2, 1.0)),
                                    time=t + int(rng.integers(0, 2000)))
                gen.set_note_panning(nid, float(rng.uniform(-1.0, 1.0)),
                                     time=t + int(rng.integers(0, 2000)))
                gen.set_note_speed(nid, float(rng.uniform(0.7, 1.5)),
                                   glide=12.0,
                                   time=t + int(rng.integers(0, 2000)))
        for pid, lo, hi in (("CUTF", 300.0, 8000.0), ("RESO", 0.1, 0.8),
                            ("SVOL", 0.25, 0.75), ("SPAN", -0.8, 0.8)):
            prog.set_parameter(gen, pid, float(rng.uniform(lo, hi)),
                               at_frame=b * N + int(rng.integers(0, N)))
    return prog, gen


def _lane_db(got, want, lanes):
    """Each lane's RMS of ``got - want`` in dB of its RMS of ``want``."""
    g = got.double().reshape(lanes, -1)
    w = want.double().reshape(lanes, -1)
    d = (g - w).pow(2).mean(1).sqrt()
    r = w.pow(2).mean(1).sqrt().clamp(min=1e-30)
    return 20.0 * torch.log10(d.clamp(min=1e-300) / r)


class _Block:
    """One block of the generator taken apart: the kernels and the plain
    version on the card from the same state and inputs."""

    def __init__(self, gen, state, params, inputs, live, ctx):
        lanes = len(params[psynth.VOLUME.id])
        nv = gen.options.voices
        n, sr, ch = ctx.block_frames, ctx.sample_rate, ctx.channels
        voice = gen.synth.kernel
        rows = tree_map(lambda a: a.flatten(0, 1), state["synth"])
        svf = filters.TptState(rows["svf"].ic1.contiguous(),
                               rows["svf"].ic2.contiguous())
        # the kernels, stage by stage
        slots = synthvoice.slot_rows(inputs, live, n)
        mod = synthvoice.sources(voice, gen.mod_config, params,
                                 inputs["_mod_amt"], inputs["_mod_bip"], sr)
        p = {pid: params[pid].contiguous() for pid in IDS}
        self.kv = synthvoice.voice_kernel(
            voice, rows["phase"].contiguous(), p, slots, mod, sr,
            gen.glide_secs, ch, *IDS[4:])
        s1, s2 = scan.iir2(*self.kv.operands, svf.ic1, svf.ic2)
        self.svf_k, self.audio_k = synthvoice.mix_kernel(
            s1, s2, svf, self.kv.gains, lanes, ch)
        # the plain version
        voice_no = torch.arange(1, nv + 1, device=svf.ic1.device)
        if lanes == 1:
            pr = {k: x[0] for k, x in params.items()}
            vs = {k: x[0] for k, x in inputs.items()}
        else:
            pr, vs = voice_rows(params, inputs, nv)
            voice_no = voice_no.repeat(lanes)
        notes = synthvoice.note_logic(vs, live, n, sr, gen.glide_secs)
        self.pv = synthvoice.voice_plain(
            voice, rows["phase"], pr, notes,
            (gen.mod_config, vs["_mod_amt"], vs["_mod_bip"]), voice_no, sr,
            ch, *IDS[4:])
        s1, s2 = scan.linear_recurrence_2(*self.pv.operands, svf.ic1,
                                          svf.ic2)
        self.svf_p, self.audio_p = synthvoice.mix_plain(self.pv, s1, s2, svf,
                                                        lanes, ch)
        self.lanes = lanes
        self.slots = slots.time.shape[1]
        self.state = {"synth": tree_map(
            lambda a: a.unflatten(0, (lanes, nv)),
            {"phase": self.pv.phase, "svf": self.svf_p})}

    def check(self, label):
        lanes, kv, pv = self.lanes, self.kv, self.pv
        eg = pv.env * pv.gain
        plain_gains = [eg * f for f in pv.pan]
        worst = {}
        for name, got, want in (
                [(f"operand {j}", kv.operands[j], pv.operands[j])
                 for j in range(6)]
                + [(f"gain {j}", kv.gains[j], w)
                   for j, w in enumerate(plain_gains)]
                + [("audio", self.audio_k, self.audio_p),
                   ("ic1", self.svf_k.ic1, self.svf_p.ic1),
                   ("ic2", self.svf_k.ic2, self.svf_p.ic2)]):
            assert got.shape == want.shape, (label, name)
            assert bool(torch.isfinite(got).all()), (label, name)
            db = _lane_db(got, want, lanes)
            worst[name] = float(db.max())
            assert bool((db <= TOLERANCE_DB).all()), (label, name, db)
        ulp = (torch.nextafter(pv.phase, torch.full_like(pv.phase, 2.0))
               - pv.phase)
        assert bool(((kv.phase - pv.phase).abs() <= ulp).all()), label
        print(label, f"K={self.slots}",
              {k: round(v, 1) for k, v in worst.items()})


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_kernels_match_plain_version(dev, case, monkeypatch):
    lanes = case[6]
    progs = [_program(case, dev, lane) for lane in range(lanes)]
    if lanes == 1:
        prog = progs[0][0]
        step, state = prog.step, prog.init_state()
        inputs = lambda b: prog.block_inputs(b)  # noqa: E731
    else:
        batched = BatchedRenderProgram(progs[0][0], lanes=lanes)
        step, state = batched.step, batched.init_states()
        inputs = lambda b: [p.block_inputs(b) for p, _ in progs]  # noqa: E731
    routed = psynth.SynthGenerator.render_lanes
    seen = []

    def render_lanes(self, state, params, ins, live, frame0, ctx):
        block = _Block(self, state, params, ins, live, ctx)
        tracing.reset()
        tracing.enable()
        try:
            _, audio = routed(self, state, params, ins, live, frame0, ctx)
            torch.cuda.synchronize()
            counts = tracing.counters()
        finally:
            tracing.disable()
        seen.append((block, audio, counts))
        return block.state, block.audio_p

    monkeypatch.setattr(psynth.SynthGenerator, "render_lanes", render_lanes)
    most = 0
    for b in range(BLOCKS):
        state, _ = step(state, inputs(b))
        block, audio, counts = seen[-1]
        block.check(f"{case[0]} block {b}")
        assert torch.equal(audio, block.audio_k), b
        for name in ("kernel.synth_voice", "kernel.iir2", "kernel.synth_mix"):
            assert counts.get(name, 0) == 1, (name, counts)
        most = max(most, block.slots)
        assert float(block.audio_p.abs().max()) > 0.01
    assert most == 8 or case[0] != "eight-starts"


def test_wrapper_raises_on_the_card(dev):
    """The wrappers check their operands on the card too: a CPU operand, a
    float64 one, a wrong shape."""
    rows, n = 4, 256
    f = dict(dtype=torch.float32, device=dev)
    s = torch.zeros(rows, n, **f)
    svf = filters.TptState(torch.zeros(rows, **f), torch.zeros(rows, **f))
    gains = torch.zeros(2, rows, n, **f)
    for bad, exc in (({"s1": s.cpu()}, ValueError),
                     ({"s2": s.double()}, TypeError),
                     ({"gains": torch.zeros(3, rows, n, **f)}, ValueError)):
        args = dict(s1=s, s2=s, svf=svf, gains=gains, lanes=1, channels=2)
        args.update(bad)
        with pytest.raises(exc):
            synthvoice.mix_kernel(**args)
