"""The chorus's feedback line (``ops/chorusline.py``) on the CPU.

* ``ChorusEffect.process`` gives, bit for bit, what its sub-block loop gave
  when it was written inline in the effect: output and every state field,
  each filter type, feedback up to the +-0.999 clamp, over blocks that
  carry the state.
* The plain line gives the same output bit for bit at every allowed
  sub-block length: nothing in it sums over samples, which is what lets
  the kernel walk tiles of any length up to ``b``.
* A read at the ``b + 1`` clamp at the first sample of a sub-block takes
  the sample written ``b + 1`` samples earlier (and, at an integer
  position, its partner ``b`` earlier): the youngest the kernel's tiles of
  at most ``b`` samples may read.
* The kernel's wrapper raises on CPU tensors and on bad operands before it
  builds or loads anything; CPU tensors route to the plain loop.
* The router hands the kernel contiguous operands, as it requires, from
  strided views.
"""

import numpy as np
import pytest
import torch

from phonic_tpu_torch import kernels
from phonic_tpu_torch.effects import chorus
from phonic_tpu_torch.graph.batching import stack_states
from phonic_tpu_torch.graph.nodes import BuildCtx
from phonic_tpu_torch.ops import chorusline, chrono

SR = 48000
LANES = 4


def _loop_as_inline(pos, filtered, feedback, win, b):
    """The effect's sub-block loop as it was written inside
    ``ChorusEffect.process`` before it moved to ``ops/chorusline.py``."""
    n = pos.shape[-1]
    wets = []
    for t0 in range(0, n, b):
        d = chrono.read_frac_win(win, pos[..., t0:t0 + b])
        win = chrono.roll(
            win, filtered[..., t0:t0 + b] + d * feedback[..., t0:t0 + b])
        wets.append(d)
    return torch.cat(wets, dim=-1), win


def _params(block, n):
    def ramp(v0, v1):
        return torch.linspace(v0, v1, n)[None].repeat(LANES, 1)

    def full(v):
        return torch.full((LANES, n), float(v))

    fb = 0.999 if block % 2 else -0.999
    return {
        chorus.RATE.id: ramp(0.5, 2.0 + block), chorus.PHASE.id: full(1.0),
        chorus.DEPTH.id: ramp(0.25, 0.9),
        # past the clamp on one lane, at it on another
        chorus.FEEDBACK.id: torch.stack([ramp(0.5, fb)[0], full(1.5)[0],
                                         full(fb)[0], ramp(-1.2, 0.3)[0]]),
        # down to 0 ms: the read positions meet the b + 1 clamp
        chorus.DELAY.id: ramp(12.0, 0.0 if block == 1 else 30.0),
        chorus.WET.id: full(0.5),
        chorus.FILTER_TYPE.id: torch.tensor([0.0, 1.0, 2.0, 0.0])[:, None]
        .repeat(1, n),
        chorus.FILTER_FREQ.id: ramp(8000.0, 3000.0),
        chorus.FILTER_RES.id: full(0.3)}


@pytest.mark.parametrize("n", [2048, 8192])
def test_effect_equals_the_inline_loop(n, monkeypatch):
    ctx = BuildCtx(SR, 2, n, 16, torch.float32, torch.device("cpu"))
    effects = [chorus.ChorusEffect() for _ in range(LANES)]
    assert effects[0]._subblock(ctx) < n  # several sub-blocks per block
    moved = stack_states([e.init_state(ctx) for e in effects])
    inline = moved
    rng = np.random.default_rng(n)
    for block in range(3):
        x = torch.as_tensor(rng.normal(size=(LANES, 2, n)).astype(np.float32)
                            * 0.3)
        p = _params(block, n)
        moved, y_moved = effects[0].process(moved, x, p, ctx)
        monkeypatch.setattr(chorus, "line", _loop_as_inline)
        inline, y_inline = effects[0].process(inline, x, p, ctx)
        monkeypatch.undo()
        assert torch.equal(y_moved, y_inline), block
        for a, b in zip(torch.utils._pytree.tree_leaves(moved),
                        torch.utils._pytree.tree_leaves(inline)):
            assert torch.equal(a, b), block
    assert float(y_moved.abs().max()) > 0.01


B_TOP = 512
N_SWEEP = 2048
W = chrono.hist_len(5362)  # the window at 48 kHz


def _line_operands(n=N_SWEEP, lanes=LANES, w=W, seed=0):
    rng = np.random.default_rng(seed)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32))

    pos = rng.uniform(B_TOP + 1, w - 2, (lanes, 2, n))
    pos.flat[::5] = np.round(pos.flat[::5])  # integer positions too
    pos[0, :, ::3] = B_TOP + 1  # the clamp
    return dict(pos=tensor(pos),
                filtered=tensor(rng.normal(size=(lanes, 2, n)) * 0.3),
                feedback=tensor(rng.uniform(-0.999, 0.999, (lanes, 1, n))),
                win=tensor(rng.normal(size=(lanes, 2, w)) * 0.3))


@pytest.mark.parametrize("b", [1 << k for k in range(10)])
def test_every_allowed_subblock_gives_the_same_block(b):
    ops = _line_operands()
    want = chorusline.line_plain(**ops, b=B_TOP)
    got = chorusline.line_plain(**ops, b=b)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("frac", [0.0, 0.25], ids=["integer", "fraction"])
def test_clamped_read_takes_the_sample_b_plus_1_before(frac):
    """With feedback 0 the line holds the input.  At pos = b + 1 the first
    sample of each sub-block reads the input b + 1 samples earlier; at b +
    1 - frac it interpolates toward the one b samples earlier, the newest
    sample before the sub-block."""
    g, b, n, w = 2, 32, 128, 256
    x = (torch.arange(n, dtype=torch.float32) + 1.0).repeat(g, 2, 1)
    x[:, 1] += 1000.0
    win = torch.zeros(g, 2, w)
    win[..., -1] = -7.0  # the newest sample before the block
    pos = torch.full((g, 2, n), b + 1 - frac)
    wet, _ = chorusline.line_plain(pos, x, torch.zeros(g, 1, n), win, b)
    for s in range(2, n // b):
        t = s * b - b - 1
        want = x[..., t] + (x[..., t + 1] - x[..., t]) * frac
        assert torch.equal(wet[..., s * b], want), s
    # the second sub-block's first sample: the old window's newest and the
    # block's first sample
    assert torch.equal(wet[..., b], -7.0 + (x[..., 0] + 7.0) * frac)


def _no_build():
    raise AssertionError("the wrapper built the kernels before it checked")


@pytest.mark.parametrize("bad,exc", [
    ({}, ValueError),  # CPU tensors: the kernel runs on the card only
    ({"pos": torch.zeros(2, 1, 64)}, ValueError),
    ({"pos": torch.zeros(2, 2, 64, dtype=torch.float64)}, TypeError),
    ({"filtered": torch.zeros(2, 2, 63)}, ValueError),
    ({"feedback": torch.zeros(2, 2, 64)}, ValueError),
    ({"win": torch.zeros(2, 2, 256, dtype=torch.float64)}, TypeError),
    ({"win": torch.zeros(3, 2, 256)}, ValueError),
    ({"win": torch.zeros(2, 2, chorusline.MAX_WINDOW + 1)}, ValueError),
    ({"filtered": torch.zeros(2, 2, 128)[..., ::2]}, ValueError),
    ({"b": 0}, ValueError),
    ({"b": 65}, ValueError),
], ids=["cpu", "channels", "dtype", "length", "feedback_rows", "scan_dtype",
        "lanes", "window_too_long", "strided", "b0", "b_over_n"])
def test_wrapper_raises_before_building(bad, exc, monkeypatch):
    monkeypatch.setattr(kernels, "library", _no_build)
    ops = dict(pos=torch.full((2, 2, 64), 40.0),
               filtered=torch.zeros(2, 2, 64), feedback=torch.zeros(2, 1, 64),
               win=torch.zeros(2, 2, 256), b=32)
    ops.update(bad)
    if bad:  # CPU tensors that claim to be on the card reach each check
        monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    with pytest.raises(exc):
        chorusline.line_kernel(**ops)


def test_routes_by_device(monkeypatch):
    """CPU tensors take the plain loop; the kernel is never asked."""
    monkeypatch.setattr(chorusline, "line_kernel", _no_build)
    ops = _line_operands(n=1024, lanes=1)
    got = chorusline.line(**ops, b=B_TOP)
    want = chorusline.line_plain(**ops, b=B_TOP)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _strided(t):
    """``t``'s values in a view with a stride of 2 along its last axis."""
    return torch.stack([t, t], dim=-1)[..., 0]


def test_router_hands_the_kernel_contiguous_operands(monkeypatch):
    """The kernel takes contiguous operands; the window a lane-batched
    program hands on may be a view: the router makes CUDA operands
    contiguous before it launches, values unchanged."""
    seen = []

    def spy(*args):
        seen.append(args)
        return "launched"

    monkeypatch.setattr(chorusline, "line_kernel", spy)
    ops = {k: _strided(t) for k, t in _line_operands(n=1024).items()}
    assert not any(t.is_contiguous() for t in ops.values())
    monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    assert chorusline.line(**ops, b=B_TOP) == "launched"
    (args,) = seen
    assert args[4] == B_TOP
    for t, want in zip(args[:4], ops.values()):
        assert t.is_contiguous() and torch.equal(t, want)
