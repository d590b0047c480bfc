"""Kernel 7 (``phonic_tpu_torch/csrc/delay.cu``) against the plain feedback
loop on the card, through ``DelayEffect.process``.

Needs a CUDA card and ``nvcc``; without them every test skips.  On the
card: ``python -m pytest --noconftest -m cuda tests/test_torch_delay_cuda.py
-q``.

Each case renders 16 blocks of a tone mixture with per-sample parameter
ramps.  At every block both versions start from the same state (the plain
version's, carried over the 16 blocks), and the plain loop also runs in
float64 on the CPU from that state.  Two checks per block and lane, each in
dB of the lane's wet RMS:

- the kernel's wet output is as close to the float64 loop as the plain
  version's is: its error power over the lanes at most 4 times the plain
  version's (6 dB), or under -114 dB where the plain version is under
  -120.  Over the lanes, since two float32 evaluations scatter by a few dB
  per lane around the same error, and by up to 10 dB where the loop rings
  (drive 0.6, feedback 0.95, several round trips in one block);
- the kernel agrees with the plain version to -110 dB (the wet output, the
  effect's output and the line; the SVF, DC and feedback states, a sample
  each, in dB of the lane's wet peak) wherever
  the plain version is within -116 dB of the float64 loop.  The bound is
  float32 rounding: the kernel's scans associate in another order than the
  iir2 / iir1 look-back kernels the plain version runs on the card, and two
  float32 errors under -116 dB differ by at most -110 dB.  A highpass in the
  loop at drive 0.6 and feedback 0.95 puts the plain version itself at
  -102..-106 dB from float64 (the filter's output is the difference of
  nearly equal terms), and there only the first check applies.

Where the loop contracts (no drive, or feedback 0.4) each version also
carries its own state over the 16 blocks, under the second check.  With
drive 0.6 and feedback 0.95 the loop's small-signal gain is above 1 (it
rings at its clamp), and two float32 evaluations drift apart over the
blocks whatever computes them: the plain loop run with half its sub-block
drifts from itself to about -106 dB in 16 blocks of 8192 frames.
"""

import math

import numpy as np
import pytest
import torch

from phonic_tpu_torch import tracing
from phonic_tpu_torch.effects import delay
from phonic_tpu_torch.graph.batching import stack_states
from phonic_tpu_torch.graph.nodes import BuildCtx
from phonic_tpu_torch.ops import delayline

pytestmark = pytest.mark.cuda

SR = 48000
BLOCKS = 16
# the sub-blocks the minimum delays give at 48 kHz, and a window for each
MIN_DELAY = {1024: (40.0, 300.0), 8192: (250.0, 1000.0)}
LFO_TARGETS = {"time": delay.LFO_TIME, "feedback": delay.LFO_FB,
               "filter": delay.LFO_FILTER}

# (mode, filter type, drive, feedback, LFO targets, b, lanes, n); every value
# of each axis appears, the mastering cell's shape among them
CASES = [
    ("Stereo", 0, 0.0, 0.4, ("time",), 1024, 1, 8192),
    ("Ping Pong", 1, 0.6, 0.95, ("feedback",), 1024, 8, 8192),
    ("Stereo", 2, 0.6, 0.95, ("filter",), 8192, 8, 131072),
    ("Ping Pong", 0, 0.0, 0.95, ("time",), 8192, 1, 131072),
    ("Stereo", 1, 0.0, 0.4, ("filter",), 8192, 8, 8192),
    ("Ping Pong", 2, 0.6, 0.4, ("feedback",), 1024, 1, 131072),
    ("Stereo", 0, 0.0, 0.4, (), 8192, 8, 131072),
    ("Ping Pong", 0, 0.6, 0.95, ("time", "feedback", "filter"), 1024, 8,
     131072),
]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _setup(case, dev):
    mode, ftype, drive, fb, lfo, b, lanes, n = case
    min_ms, cap_ms = MIN_DELAY[b]
    ctx = BuildCtx(SR, 2, n, 16, torch.float32, dev)
    effects = [delay.DelayEffect(min_delay_ms=min_ms,
                                 max_delay_capacity_ms=cap_ms)
               for _ in range(lanes)]
    assert effects[0]._subblock(ctx) == b
    rng = np.random.default_rng(b + lanes + n + ftype)
    t = np.arange(BLOCKS * n) / SR
    freqs = rng.uniform(80.0, 2000.0, (lanes, 2, 3, 1))
    phases = rng.uniform(0.0, 2.0 * math.pi, (lanes, 2, 3, 1))
    tones = (0.3 * np.sin(2 * np.pi * freqs * t + phases).sum(axis=2)
             + 0.05).astype(np.float32)

    def block(k):
        def ramp(v0, v1):
            r = np.linspace(v0, v1, n, dtype=np.float32)
            return np.tile(r, (lanes, 1)) * (1.0 + 0.05 * np.arange(
                lanes, dtype=np.float32))[:, None]

        def full(v):
            return np.full((lanes, n), v, np.float32)

        p = {prm.id: full(0.0) for prm in delay.DelayEffect.PARAMS}
        p[delay.MODE.id] = full(delay.MODE.index_of(mode))
        p[delay.FILTER_TYPE.id] = full(ftype)
        p[delay.DRIVE.id] = full(drive)
        p[delay.FEEDBACK.id] = np.minimum(ramp(0.9 * fb, fb), 1.0)
        p[delay.DELAY_TIME.id] = ramp(min_ms + 40.0, min_ms + 60.0 + 10 * k)
        p[delay.FILTER_CUTOFF.id] = ramp(6000.0, 2000.0 + 200.0 * k)
        p[delay.LFO_RATE.id] = full(2.0)
        p[delay.LFO_SHAPE.id] = full(k % 3)
        for name in lfo:
            p[LFO_TARGETS[name].id] = full(0.8)
        p[delay.WET.id] = full(0.5)
        p[delay.WIDTH.id] = full(0.7)
        x = np.ascontiguousarray(tones[..., k * n:(k + 1) * n])
        return (torch.as_tensor(x, device=dev),
                {key: torch.as_tensor(v, device=dev) for key, v in p.items()})

    state = stack_states([e.init_state(ctx) for e in effects])
    return effects[0], ctx, block, state


def _process(effect, state, x, params, ctx, loop, monkeypatch):
    """One block of the effect with its loop routed to ``loop``: (state,
    output, wet, the loop's arguments)."""
    seen = []

    def spy(*args):
        out = loop(*args)
        seen.append((out[0], args))
        return out

    monkeypatch.setattr(delay, "feedback_loop", spy)
    st, y = effect.process(state, x, params, ctx)
    return st, y, seen[0][0], seen[0][1]


def _float64_wet(args):
    """The plain loop's wet output in float64 on the CPU (the card's plain
    version runs its scans in float32 kernels)."""
    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.cpu().double() if a.is_floating_point() else a.cpu()
        if isinstance(a, tuple):
            return type(a)(*(f64(t) for t in a))
        return a
    wet = delayline.feedback_loop_plain(*(f64(a) for a in args[:-1]),
                                        dtype=torch.float64)[0]
    return wet.to(args[0].device)


def _flat(state):
    """The carried fields, each [G, 2, ...]."""
    return {"svf.ic1": state["svf"].ic1, "svf.ic2": state["svf"].ic2,
            "dc.y1": state["dc"].y1, "dc.x1": state["dc"].x1,
            "fb": state["fb"], "line": state["line"].hist}


def _contiguous(state):
    """A state the kernel takes: the plain version leaves its fields as
    views of its last sub-block."""
    return {k: (type(v)(*(t.contiguous() for t in v)) if isinstance(v, tuple)
                else v.contiguous()) for k, v in state.items()}


def _db(got, want, scale):
    """Per lane: RMS of the difference over ``scale`` [G], in dB."""
    err = (got.double() - want.double()).flatten(1).pow(2).mean(1).sqrt()
    return 20.0 * torch.log10(torch.clamp(err, min=1e-30) / scale)


def _compare(label, got, want, ref, accuracy=True):
    """The checks of the module docstring for one block (the first only
    with ``accuracy``)."""
    st_g, y_g, wet_g = got[:3]
    st_w, y_w, wet_w = want[:3]
    scale = torch.clamp(ref.flatten(1).pow(2).mean(1).sqrt(), min=1e-6)
    plain, kernel = _db(wet_w, ref, scale), _db(wet_g, ref, scale)

    def over_lanes(db):
        return float(10.0 * torch.log10(torch.pow(10.0, db / 10.0).mean()))

    assert not accuracy or over_lanes(kernel) <= max(
        over_lanes(plain), -120.0) + 6.0, (
            label, "against float64", kernel.tolist(), plain.tolist())
    room = plain <= -116.0
    diffs = {"wet": _db(wet_g, wet_w, scale), "out": _db(y_g, y_w, scale)}
    # the states are one sample each: against the lane's peak; the line, a
    # signal, against its RMS
    peak = torch.clamp(ref.flatten(1).abs().max(1).values, min=1e-6)
    fg, fw = _flat(st_g), _flat(st_w)
    for key in fw:
        diffs[key] = _db(fg[key], fw[key], scale if key == "line" else peak)
    worst = {k: float(torch.where(room, v, -300.0).max())
             for k, v in diffs.items()}
    assert max(worst.values()) <= -110.0, (label, worst, plain.tolist())


@pytest.mark.parametrize("case", CASES, ids=[
    f"{c[0][0]}-f{c[1]}-d{c[2]}-fb{c[3]}-{'+'.join(c[4]) or 'nolfo'}-b{c[5]}"
    f"-G{c[6]}-n{c[7]}" for c in CASES])
def test_kernel_matches_plain_loop(dev, case, monkeypatch):
    effect, ctx, block, state = _setup(case, dev)
    own = _contiguous(state)
    contracts = case[2] == 0.0 or case[3] < 0.9
    for k in range(BLOCKS):
        x, params = block(k)
        want = _process(effect, state, x, params, ctx,
                        delayline.feedback_loop_plain, monkeypatch)
        ref = _float64_wet(want[3])
        got = _process(effect, _contiguous(state), x, params, ctx,
                       delayline.feedback_loop_kernel, monkeypatch)
        _compare(f"block {k}, from the plain version's state", got, want,
                 ref)
        if contracts:
            mine = _process(effect, own, x, params, ctx,
                            delayline.feedback_loop_kernel, monkeypatch)
            _compare(f"block {k}, each version's own state", mine, want,
                     ref, accuracy=False)
            own = mine[0]
        state = want[0]


def test_one_launch_per_block(dev):
    """A delay block launches kernel 7 once and no scan kernel."""
    effect, ctx, block, state = _setup(CASES[-1], dev)
    x, params = block(0)
    tracing.reset()
    tracing.enable()
    try:
        effect.process(state, x, params, ctx)
        torch.cuda.synchronize()
        counts = tracing.counters()
    finally:
        tracing.disable()
    assert counts.get("kernel.delay", 0) == 1, counts
    assert counts.get("kernel.iir1", 0) == 0, counts
    assert counts.get("kernel.iir2", 0) == 0, counts
