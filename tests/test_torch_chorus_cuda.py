"""Kernel 9 (``phonic_tpu_torch/csrc/chorus.cu``) against the plain
feedback line on the card, through ``ChorusEffect.process``.

Needs a CUDA card and ``nvcc``; without them every test skips.  On the
card: ``python -m pytest --noconftest -m cuda tests/test_torch_chorus_cuda.py
-q``.

Each case renders 8 blocks of 8192 frames of a tone mixture through G
choruses (the Player's 4 sub-mixers, and 8), each lane its own filter type,
with the depth and the delay automated so the read positions run down to
the ``b + 1`` clamp, and the feedback at and past +-0.999.  At every block
both versions start from the same state (the plain version's), and the
plain line also runs on the CPU, in float32 and in float64, from that
state.  The checks:

- the kernel equals the plain version bit for bit, on the card and on the
  CPU: the wet signal, the effect's output and the window.  Nothing sums
  over samples, and every step runs in the plain version's order without
  FMA;
- against the float64 line the kernel's wet signal is under -100 dB of the
  lane's wet RMS: float32 rounding of a read, a product and a sum per
  sample, which a feedback of 0.999 carries over a few round trips per
  block (it forgets it slowly, but each block restarts from the float32
  state);
- each version also carries its own state over the blocks, under the first
  check.

Apart from those: launches are counted, and the wrapper raises on a wrong
shape, device or dtype.
"""

import math

import numpy as np
import pytest
import torch

from phonic_tpu_torch import tracing
from phonic_tpu_torch.effects import chorus
from phonic_tpu_torch.graph.batching import stack_states
from phonic_tpu_torch.graph.nodes import BuildCtx
from phonic_tpu_torch.ops import chorusline

pytestmark = pytest.mark.cuda

SR = 48000
N = 8192
BLOCKS = 8
LANES = (4, 8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _setup(lanes, dev):
    ctx = BuildCtx(SR, 2, N, 16, torch.float32, dev)
    effects = [chorus.ChorusEffect() for _ in range(lanes)]
    assert effects[0]._subblock(ctx) == 512
    rng = np.random.default_rng(lanes)
    t = np.arange(BLOCKS * N) / SR
    freqs = rng.uniform(80.0, 2000.0, (lanes, 2, 3, 1))
    phases = rng.uniform(0.0, 2.0 * math.pi, (lanes, 2, 3, 1))
    tones = (0.3 * np.sin(2 * np.pi * freqs * t + phases).sum(axis=2)
             ).astype(np.float32)

    def block(k):
        def ramp(v0, v1):
            r = np.linspace(v0, v1, N, dtype=np.float32)
            return np.tile(r, (lanes, 1))

        def full(v):
            return np.full((lanes, N), v, np.float32)

        sign = 1.0 if k % 2 else -1.0
        fb = ramp(0.5 * sign, 0.999 * sign)
        fb[1::2] = 1.4 * sign  # past the clamp
        p = {chorus.RATE.id: ramp(0.5, 1.0 + 0.5 * k),
             chorus.PHASE.id: full(1.0), chorus.DEPTH.id: ramp(0.2, 0.9),
             chorus.FEEDBACK.id: fb,
             # down to 0 ms every other block: positions at the clamp
             chorus.DELAY.id: ramp(12.0, 0.0 if k % 2 else 40.0),
             chorus.WET.id: full(0.5),
             chorus.FILTER_TYPE.id: np.tile(
                 (np.arange(lanes, dtype=np.float32) % 3)[:, None], (1, N)),
             chorus.FILTER_FREQ.id: ramp(9000.0, 2500.0),
             chorus.FILTER_RES.id: full(0.3)}
        x = np.ascontiguousarray(tones[..., k * N:(k + 1) * N])
        return (torch.as_tensor(x, device=dev),
                {key: torch.as_tensor(v, device=dev) for key, v in p.items()})

    state = stack_states([e.init_state(ctx) for e in effects])
    return effects[0], ctx, block, state


def _process(effect, state, x, params, ctx, line, monkeypatch):
    """One block with the line routed to ``line`` (the plain version, or
    the router, which launches the kernel): (state, output, wet, the line's
    arguments)."""
    seen = []

    def spy(*args):
        out = line(*args)
        seen.append((out[0], args))
        return out

    monkeypatch.setattr(chorus, "line", spy)
    st, y = effect.process(state, x, params, ctx)
    monkeypatch.undo()
    return st, y, seen[0][0], seen[0][1]


def _on_cpu(args, dtype):
    return [a.cpu().to(dtype) if isinstance(a, torch.Tensor) else a
            for a in args]


def _same(label, got, want):
    assert torch.equal(got[1], want[1]), (label, "output")
    assert torch.equal(got[2], want[2]), (label, "wet")
    assert torch.equal(got[0]["line"].hist, want[0]["line"].hist), (
        label, "window")


@pytest.mark.parametrize("lanes", LANES)
def test_kernel_matches_plain_line(dev, lanes, monkeypatch):
    effect, ctx, block, state = _setup(lanes, dev)
    own = state
    clamped = 0
    for k in range(BLOCKS):
        x, params = block(k)
        want = _process(effect, state, x, params, ctx,
                        chorusline.line_plain, monkeypatch)
        got = _process(effect, state, x, params, ctx,
                       chorusline.line, monkeypatch)
        _same(f"block {k}, from the plain version's state", got, want)
        args = want[3]
        pos, b = args[0], args[4]
        clamped += int((pos == b + 1).sum())
        cpu = chorusline.line_plain(*_on_cpu(args, torch.float32))
        assert torch.equal(got[2].cpu(), cpu[0]), k
        assert torch.equal(got[0]["line"].hist.cpu(), cpu[1]), k
        ref = chorusline.line_plain(*_on_cpu(args, torch.float64))[0]
        scale = torch.clamp(ref.flatten(1).pow(2).mean(1).sqrt(), min=1e-6)
        err = (got[2].cpu().double() - ref).flatten(1).pow(2).mean(1).sqrt()
        db = 20.0 * torch.log10(torch.clamp(err, min=1e-30) / scale)
        print(f"block {k}: float64 error {db.tolist()} dB")
        assert float(db.max()) <= -100.0, (k, db.tolist())
        mine = _process(effect, own, x, params, ctx,
                        chorusline.line, monkeypatch)
        _same(f"block {k}, each version's own state", mine, want)
        own, state = mine[0], want[0]
    assert clamped > 0  # the reads met the b + 1 clamp
    assert float(want[1].abs().max()) > 0.01


def test_one_launch_per_block(dev):
    """A chorus block launches kernel 9 once, and iir2 for its input
    filter."""
    effect, ctx, block, state = _setup(4, dev)
    x, params = block(0)
    tracing.reset()
    tracing.enable()
    try:
        effect.process(state, x, params, ctx)
        torch.cuda.synchronize()
        counts = tracing.counters()
    finally:
        tracing.disable()
    assert counts.get("kernel.chorus", 0) == 1, counts
    assert counts.get("kernel.iir2", 0) == 1, counts


def _operands(dev, **bad):
    f = dict(dtype=torch.float32, device=dev)
    ops = dict(pos=torch.full((2, 2, 256), 40.0, **f),
               filtered=torch.zeros(2, 2, 256, **f),
               feedback=torch.zeros(2, 1, 256, **f),
               win=torch.zeros(2, 2, 512, **f), b=32)
    ops.update(bad)
    return ops


@pytest.mark.parametrize("bad,exc", [
    (lambda d: {"pos": torch.zeros(2, 3, 256, device=d)}, ValueError),
    (lambda d: {"feedback": torch.zeros(2, 2, 256, device=d)}, ValueError),
    (lambda d: {"win": torch.zeros(3, 2, 512, device=d)}, ValueError),
    (lambda d: {"filtered": torch.zeros(2, 2, 256)}, ValueError),
    (lambda d: {"win": torch.zeros(2, 2, 512)}, ValueError),
    (lambda d: {"pos": torch.zeros(2, 2, 256, dtype=torch.float64,
                                   device=d)}, TypeError),
    (lambda d: {"win": torch.zeros(2, 2, 512, dtype=torch.float64,
                                   device=d)}, TypeError),
    (lambda d: {"b": 257}, ValueError),
], ids=["channels", "feedback_rows", "lanes", "input_on_cpu",
        "window_on_cpu", "float64", "scan_dtype", "b_over_n"])
def test_wrapper_raises(dev, bad, exc):
    with pytest.raises(exc):
        chorusline.line_kernel(**_operands(dev, **bad(dev)))
