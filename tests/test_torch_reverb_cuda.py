"""Kernel 8 (``phonic_tpu_torch/csrc/reverb.cu``) against the plain delay
network on the card, through ``ReverbEffect.process``.

Needs a CUDA card and ``nvcc``; without them every test skips.  On the
card: ``python -m pytest --noconftest -m cuda tests/test_torch_reverb_cuda.py
-q``.

Each case renders 8 blocks of 8192 frames of a tone mixture with the room
automated across ``[min_room_size, max_room_size]`` (a ramp per block, each
lane its own, so the delays and the kernel's tiles move block by block) and
a scheduled reset on one lane.  At every block both versions start from the
same state (the plain version's, carried over the blocks), and the plain
network also runs in float64 on the CPU from that state.  The checks:

- the kernel equals the plain version on the card bit for bit: the wet
  signal, the effect's output, both windows and the feedback state.  No
  step of the network sums over samples; the sums over the lines and every
  elementwise step run in the plain version's order without FMA, and both
  take CUDA's float64 sine for the vibrato;
- against the float64 network on the CPU: where a vibrato offset lies
  within a float32 rounding of an integer, float64 picks the tap one
  sample apart (10-30 samples of a lane's block, counted and printed), and
  from there on the blend term's jump, fed back through the lines, leaves
  no rounding bound.  Before the first such sample of a lane and channel
  the kernel's wet signal lies within -110 dB of the lane's wet RMS of the
  float64 one (float32 rounding through the chain reads -120 to -150 dB
  in this test on the CPU); after it only the plain version's bit-for-bit
  equality holds it;
- each version also carries its own state over the blocks, under the first
  check.

Apart from those: the vibrato taps of the kernel and of the plain version
on the CPU are equal, launches are counted, and the wrapper raises on a
wrong shape, device or dtype.
"""

import math

import numpy as np
import pytest
import torch

from phonic_tpu_torch import tracing
from phonic_tpu_torch.effects import reverb
from phonic_tpu_torch.graph.batching import stack_states
from phonic_tpu_torch.graph.nodes import BuildCtx
from phonic_tpu_torch.ops import reverbnet

pytestmark = pytest.mark.cuda

SR = 48000
N = 8192
BLOCKS = 8
# (lanes, min_room_size, max_room_size): the Player's master (G = 1, floor
# 0.55) and 8 lanes over the whole range
CASES = [(1, 0.55, 1.0), (8, 0.55, 1.0), (8, 0.0, 1.0), (1, 0.0, 0.5)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _setup(case, dev):
    lanes, lo, hi = case
    ctx = BuildCtx(SR, 2, N, 16, torch.float32, dev)
    effects = [reverb.ReverbEffect(room_size=lo, wet=0.35, seed=11 + k,
                                   min_room_size=lo, max_room_size=hi)
               for k in range(lanes)]
    rng = np.random.default_rng(lanes + int(10 * lo + 100 * hi))
    t = np.arange(BLOCKS * N) / SR
    freqs = rng.uniform(80.0, 2000.0, (lanes, 2, 3, 1))
    phases = rng.uniform(0.0, 2.0 * math.pi, (lanes, 2, 3, 1))
    tones = (0.3 * np.sin(2 * np.pi * freqs * t + phases).sum(axis=2)
             ).astype(np.float32)

    def block(k):
        # the room sweeps the range and back, each lane from its own point
        u = (np.arange(lanes)[:, None] / max(lanes, 1) + k / BLOCKS
             + np.linspace(0.0, 0.2, N)[None]) % 1.0
        room = (lo + (hi - lo) * np.abs(2.0 * u - 1.0)).astype(np.float32)
        p = {reverb.ROOM_SIZE.id: torch.as_tensor(room, device=dev),
             reverb.WET.id: torch.full((lanes, N), 0.35, device=dev),
             "_reset": np.array([1.0 if (k == 3 and i == lanes - 1) else 0.0
                                 for i in range(lanes)], np.float32)}
        x = np.ascontiguousarray(tones[..., k * N:(k + 1) * N])
        return torch.as_tensor(x, device=dev), p

    state = stack_states([e.init_state(ctx) for e in effects])
    return effects[0], ctx, block, state


def _process(effect, state, x, params, ctx, network, monkeypatch):
    """One block with the network routed to ``network`` (the plain version,
    or the router, which launches the kernel): (state, output, wet, the
    network's arguments)."""
    seen = []

    def spy(*args):
        out = network(*args)
        seen.append((out[0], args))
        return out

    monkeypatch.setattr(reverb, "network", spy)
    st, y = effect.process(state, x, params, ctx)
    monkeypatch.undo()
    return st, y, seen[0][0], seen[0][1]


def _float64_wet(args):
    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.cpu().double() if a.is_floating_point() else a.cpu()
        return a
    return reverbnet.network_plain(*(f64(a) for a in args[:-1]),
                                   dtype=torch.float64)[0]


# float32 rounding through the chain, in dB of a lane's wet RMS: the
# largest error before the first tap that float64 picks apart
ROUNDING_DB = -110.0


def _taps(vib_phase, dt):
    """The vibrato taps ``floor(offset)`` [G, 8, 2, N] that the network
    picks in ``dt`` from the phase at block start, as ``network_plain``
    computes them."""
    inc = reverbnet.vib_increments(dt, "cpu")[:, None, None]
    vib = vib_phase.cpu().to(dt)[..., None] + inc * torch.arange(N, dtype=dt)
    vib_sin = torch.sin((vib + inc).double()).to(dt)
    return torch.floor((vib_sin + 1.0) * reverbnet.VIB_DEPTH)


def _rounding_db(wet, ref, vib_phase):
    """The largest error of ``wet`` against the float64 ``ref`` before the
    first sample of each lane and channel at which float32 and float64
    pick another tap of some line, in dB of the lane's wet RMS; the number
    of such samples; the number of samples compared."""
    apart = (_taps(vib_phase, torch.float32)
             != _taps(vib_phase, torch.float64)).any(1)  # [G, 2, N]
    first = torch.where(apart.any(-1), apart.float().argmax(-1), N)
    before = torch.arange(N) < first[..., None]
    scale = torch.clamp(ref.flatten(1).pow(2).mean(1).sqrt(), min=1e-6)
    err = torch.where(before, (wet.double() - ref).abs(), 0.0)
    db = 20.0 * torch.log10(torch.clamp(err.flatten(1).amax(1), min=1e-30)
                            / scale)
    return db, int(apart.sum()), int(before.sum())


def _fields(state):
    return {k: state[k] for k in ("ap_buf", "line_buf", "fb", "vib_phase")}


def _same(label, got, want):
    assert torch.equal(got[1], want[1]), (label, "output")
    assert torch.equal(got[2], want[2]), (label, "wet")
    for key, w in _fields(want[0]).items():
        assert torch.equal(_fields(got[0])[key], w), (label, key)


@pytest.mark.parametrize("case", CASES, ids=[
    f"G{c[0]}-room{c[1]}-{c[2]}" for c in CASES])
def test_kernel_matches_plain_network(dev, case, monkeypatch):
    effect, ctx, block, state = _setup(case, dev)
    own = state
    compared = 0
    for k in range(BLOCKS):
        x, params = block(k)
        want = _process(effect, state, x, params, ctx,
                        reverbnet.network_plain, monkeypatch)
        got = _process(effect, state, x, params, ctx, reverbnet.network,
                       monkeypatch)
        _same(f"block {k}, from the plain version's state", got, want)
        db, apart, seen = _rounding_db(got[2].cpu(), _float64_wet(want[3]),
                                       want[3][5])
        print(f"block {k}: {apart} samples pick a tap apart; error before "
              f"the first {db.tolist()} dB over {seen} samples")
        assert bool((db <= ROUNDING_DB).all()), (k, db)
        compared += seen
        mine = _process(effect, own, x, params, ctx, reverbnet.network,
                        monkeypatch)
        _same(f"block {k}, each version's own state", mine, want)
        own, state = mine[0], want[0]
    assert float(want[1].abs().max()) > 0.01
    # the check reaches a fair share of the samples
    assert compared >= 0.05 * BLOCKS * case[0] * 2 * N, compared


@pytest.mark.parametrize("lanes", [1, 8])
def test_vibrato_taps_equal_the_cpu(dev, lanes):
    """Blend 1 reads the older tap alone; no input and no feedback leave
    the old windows, which hold each line's index k + 8192 l (exact sums),
    as the only signal, so the wet sample is the mean of the 8 taps.  Over
    the samples whose taps still reach the old windows, the kernel's taps
    equal the plain version's on the CPU, at phases across the circle."""
    rng = np.random.default_rng(lanes)
    h = 8192
    index = (torch.arange(h, dtype=torch.float32)
             + 8192.0 * torch.arange(8, dtype=torch.float32)[:, None])
    for trial in range(4):
        room = rng.uniform(0.55, 1.0, lanes).astype(np.float32)
        size = torch.as_tensor(room * room * 75.0 + 25.0)
        ops = dict(
            drive_in=torch.zeros(lanes, 2, N),
            ap_delay=(torch.as_tensor(reverb._AP_FACTORS, dtype=torch.float32)
                      * size[:, None]).to(torch.int64),
            line_delay=(torch.as_tensor(reverb._LINE_FACTORS,
                                        dtype=torch.float32)
                        * size[:, None]).to(torch.int64),
            blend=torch.ones(lanes, N), regen=torch.zeros(lanes, N),
            vib_phase=torch.as_tensor(rng.uniform(
                0.0, 2.0 * math.pi, (lanes, 8, 2)).astype(np.float32)),
            ap_buf=torch.zeros(lanes, 4, 2, h),
            line_buf=index[None, :, None].repeat(lanes, 1, 2, 1),
            fb=torch.zeros(lanes, 8, 2))
        want = reverbnet.network_plain(**ops, b_ap=1024, b_fdn=1024)[0]
        got = reverbnet.network_kernel(
            **{k: v.to(dev) for k, v in ops.items()})[0].cpu()
        reach = int(ops["line_delay"].min()) - reverbnet.VIB_SPAN
        assert torch.equal(got[..., :reach], want[..., :reach]), trial
        # the read taps moved: the offsets cross integers inside the span
        steps = torch.diff(want[..., :reach], dim=-1)
        assert bool((steps != 1.0).any()), trial


def test_one_launch_per_block(dev):
    """A reverb block launches kernel 8 once, and iir2 for its three
    lowpasses."""
    effect, ctx, block, state = _setup(CASES[1], dev)
    x, params = block(0)
    tracing.reset()
    tracing.enable()
    try:
        effect.process(state, x, params, ctx)
        torch.cuda.synchronize()
        counts = tracing.counters()
    finally:
        tracing.disable()
    assert counts.get("kernel.reverb", 0) == 1, counts
    assert counts.get("kernel.iir2", 0) == 3, counts


def _operands(dev, lanes=2, n=256, **bad):
    f = dict(dtype=torch.float32, device=dev)
    ops = dict(
        drive_in=torch.zeros(lanes, 2, n, **f),
        ap_delay=torch.full((lanes, 4), 100, dtype=torch.int64, device=dev),
        line_delay=torch.full((lanes, 8), 200, dtype=torch.int64, device=dev),
        blend=torch.zeros(lanes, n, **f), regen=torch.zeros(lanes, n, **f),
        vib_phase=torch.zeros(lanes, 8, 2, **f),
        ap_buf=torch.zeros(lanes, 4, 2, 512, **f),
        line_buf=torch.zeros(lanes, 8, 2, 512, **f),
        fb=torch.zeros(lanes, 8, 2, **f))
    ops.update(bad)
    return ops


@pytest.mark.parametrize("bad,exc", [
    (lambda d: {"drive_in": torch.zeros(2, 3, 256, device=d)}, ValueError),
    (lambda d: {"line_buf": torch.zeros(2, 8, 2, 500, device=d)}, ValueError),
    (lambda d: {"vib_phase": torch.zeros(2, 8, device=d)}, ValueError),
    (lambda d: {"blend": torch.zeros(2, 256)}, ValueError),
    (lambda d: {"fb": torch.zeros(2, 8, 2)}, ValueError),
    (lambda d: {"drive_in": torch.zeros(2, 2, 256, dtype=torch.float64,
                                        device=d)}, TypeError),
    (lambda d: {"ap_delay": torch.zeros(2, 4, dtype=torch.int32, device=d)},
     TypeError),
    (lambda d: {"dtype": torch.float64}, TypeError),
], ids=["channels", "window", "phase", "blend_on_cpu", "state_on_cpu",
        "float64", "int32_delays", "scan_dtype"])
def test_wrapper_raises(dev, bad, exc):
    with pytest.raises(exc):
        reverbnet.network_kernel(**_operands(dev, **bad(dev)))
