"""The delay's feedback loop (``ops/delayline.py``) on the CPU.

* ``DelayEffect.process`` gives, bit for bit, what its sub-block loop gave
  when it was written inline in the effect: output and every state field,
  both modes, with the LFO on time, feedback and filter, over blocks that
  carry the state.
* The kernel's wrapper raises on CPU tensors and on bad operands before it
  builds or loads anything.
* A read of ``d = b + 1`` samples at the first sample of a sub-block takes
  the sample written ``b + 1`` samples earlier: the youngest sample the
  kernel's tiles of at most ``b`` samples may read.
* The effect hands the loop contiguous operands in a lane-batched
  mastering program, as the kernel requires.
"""

import numpy as np
import pytest
import torch

from phonic_tpu_torch import kernels
from phonic_tpu_torch.effects import delay
from phonic_tpu_torch.graph.batching import stack_states
from phonic_tpu_torch.graph.nodes import BuildCtx
from phonic_tpu_torch.ops import chrono, delayline, filters

SR = 48000
N = 4096
LANES = 2


def _loop_as_inline(x, win, svf, dc, fb_state, delay_samples, feedback,
                    drive, coefs, is_pp, dc_r, b, dt):
    """The effect's sub-block loop as it was written inside
    ``DelayEffect.process`` before the loop moved to ``ops/delayline.py``."""
    n = x.shape[-1]
    wets = []
    for t0 in range(0, n, b):
        sl = slice(t0, t0 + b)
        fb_j = feedback[:, sl]
        delayed = chrono.read_frac_win(win, delay_samples[:, None, sl])
        svf, filtered = filters.tpt_process(
            svf, delayed, filters.TptCoefficients(*(c[..., sl] for c in coefs)),
            dtype=dt)
        saturated = delay.saturate(filtered, drive[:, None, sl])
        dc, blocked = filters.dc_process(dc, saturated, dc_r, dtype=dt)
        clean = torch.clamp(blocked, -4.0, 4.0)
        prev = torch.cat([fb_state[..., None], clean[..., :-1]], dim=-1)
        x_j = x[..., sl]
        mono = (x_j[:, 0] + x_j[:, 1]) * 0.5
        l_in = torch.where(is_pp, mono + prev[:, 1] * fb_j,
                           x_j[:, 0] + prev[:, 0] * fb_j)
        r_in = torch.where(is_pp, prev[:, 0] * fb_j,
                           x_j[:, 1] + prev[:, 1] * fb_j)
        win = chrono.roll(win, torch.stack([l_in, r_in], dim=1))
        fb_state = clean[..., -1]
        wets.append(clean)
    return torch.cat(wets, dim=-1), win, svf, dc, fb_state


def _params(mode, block, rng):
    def full(v):
        return torch.full((LANES, N), float(v))

    def ramp(v0, v1):
        return torch.linspace(v0, v1, N)[None].repeat(LANES, 1)

    p = {prm.id: full(0.0) for prm in delay.DelayEffect.PARAMS}
    p.update({
        delay.MODE.id: full(mode), delay.FILTER_TYPE.id: full(block % 3),
        delay.DRIVE.id: full(0.3 * block), delay.FEEDBACK.id: ramp(0.5, 0.9),
        delay.DELAY_TIME.id: ramp(60.0, 90.0 + 10.0 * block),
        delay.FILTER_CUTOFF.id: ramp(5000.0, 1500.0),
        delay.LFO_RATE.id: full(3.0), delay.LFO_SHAPE.id: full(block),
        delay.LFO_TIME.id: full(0.6), delay.LFO_FB.id: full(-0.4),
        delay.LFO_FILTER.id: full(0.7), delay.WET.id: full(0.5),
        delay.WIDTH.id: full(0.7)})
    x = torch.as_tensor(rng.normal(size=(LANES, 2, N)).astype(np.float32)
                        * 0.3)
    return x, p


@pytest.mark.parametrize("mode", [0, 1], ids=["stereo", "ping_pong"])
def test_effect_equals_the_inline_loop(mode, monkeypatch):
    ctx = BuildCtx(SR, 2, N, 16, torch.float32, torch.device("cpu"))
    effects = [delay.DelayEffect(min_delay_ms=20.0,
                                 max_delay_capacity_ms=300.0)
               for _ in range(LANES)]
    assert effects[0]._subblock(ctx) < N  # several sub-blocks per block
    moved = stack_states([e.init_state(ctx) for e in effects])
    inline = moved
    rng = np.random.default_rng(mode)
    for block in range(3):
        x, p = _params(mode, block, rng)
        moved, y_moved = effects[0].process(moved, x, p, ctx)
        monkeypatch.setattr(delay, "feedback_loop", _loop_as_inline)
        inline, y_inline = effects[0].process(inline, x, p, ctx)
        monkeypatch.undo()
        assert torch.equal(y_moved, y_inline), block
        for a, b in zip(torch.utils._pytree.tree_leaves(moved),
                        torch.utils._pytree.tree_leaves(inline)):
            assert torch.equal(a, b), block
    assert float(y_moved.abs().max()) > 0.01  # the echo came back


def _operands(g=2, n=64, w=256, **bad):
    """The kernel's operands on the CPU, with ``bad`` replacing some."""
    f = dict(dtype=torch.float32)
    ops = dict(
        x=torch.zeros(g, 2, n, **f), line=torch.zeros(g, 2, w, **f),
        svf=filters.TptState(torch.zeros(g, 2), torch.zeros(g, 2)),
        dc=filters.DcState(torch.zeros(g, 2), torch.zeros(g, 2)),
        fb=torch.zeros(g, 2), delay_samples=torch.full((g, n), 40.0),
        feedback=torch.zeros(g, n), drive=torch.zeros(g, n),
        coefs=filters.TptCoefficients(*(torch.zeros(g, 1, n)
                                        for _ in range(6))),
        ping_pong=torch.zeros(g, 1, dtype=torch.bool), dc_r=0.999, b=32)
    ops.update(bad)
    return ops


def _no_build():
    raise AssertionError("the wrapper built the kernels before it checked")


@pytest.mark.parametrize("bad,exc", [
    ({}, ValueError),  # CPU tensors: the kernel runs on the card only
    ({"x": torch.zeros(2, 1, 64)}, ValueError),
    ({"x": torch.zeros(2, 2, 64, dtype=torch.float64)}, TypeError),
    ({"line": torch.zeros(3, 2, 256)}, ValueError),
    ({"fb": torch.zeros(2, 3)}, ValueError),
    ({"delay_samples": torch.zeros(2, 65)}, ValueError),
    ({"drive": torch.zeros(2, 128)[:, ::2]}, ValueError),
    ({"ping_pong": torch.zeros(2, 1)}, TypeError),
    ({"ping_pong": torch.zeros(3, dtype=torch.bool)}, ValueError),
    ({"b": 0}, ValueError),
    ({"b": 65}, ValueError),
], ids=["cpu", "channels", "dtype", "line", "state", "length", "strided",
        "flag_dtype", "flags", "b0", "b_over_n"])
def test_wrapper_raises_before_building(bad, exc, monkeypatch):
    monkeypatch.setattr(kernels, "library", _no_build)
    if bad:  # CPU tensors that claim to be on the card reach each check
        monkeypatch.setattr(torch.Tensor, "is_cuda", True)
    with pytest.raises(exc):
        delayline.feedback_loop_kernel(**_operands(**bad))


def test_shortest_delay_reads_the_sample_written_b_plus_1_before(monkeypatch):
    """With feedback 0 the line holds the input; at d = b + 1 the first
    sample of each sub-block reads the input b + 1 samples earlier (the old
    window's newest sample for the second sub-block)."""
    g, b, n, w = 2, 32, 128, 256
    x = (torch.arange(n, dtype=torch.float32) + 1.0).repeat(g, 2, 1)
    x[:, 1] += 1000.0
    reads, read = [], chrono.read_frac_win

    def spy(win, offsets):
        out = read(win, offsets)
        reads.append(out)
        return out

    monkeypatch.setattr(chrono, "read_frac_win", spy)
    ops = _operands(g, n, w, x=x, b=b,
                    delay_samples=torch.full((g, n), float(b + 1)))
    ops["line"][..., -1] = -7.0  # the newest sample before the block
    delayline.feedback_loop_plain(**ops)
    assert len(reads) == n // b
    assert bool((reads[0][..., 0] == 0.0).all())  # older than the window
    assert bool((reads[1][..., 0] == -7.0).all())  # t0 - b - 1 = -1
    for s in range(2, n // b):
        t = s * b - b - 1
        assert torch.equal(reads[s][..., 0], x[..., t]), s


def test_effect_hands_contiguous_operands(monkeypatch):
    from phonic_tpu_torch.mastering import mastering_program
    from phonic_tpu_torch.parallel.mesh import BatchedRenderProgram
    seen = []

    def spy(*args):
        seen.append(args)
        return delayline.feedback_loop_plain(*args)

    monkeypatch.setattr(delay, "feedback_loop", spy)
    prog = BatchedRenderProgram(
        mastering_program(block_frames=8192, device="cpu"), lanes=2)
    prog.render(2 * 8192)
    assert len(seen) == 2
    for k, args in enumerate(seen):
        x, line, svf, dc, fb, dly, fbk, drive, coefs, pp = args[:10]
        operands = [x, dly, fbk, drive, pp, *coefs]
        if k == 0:  # the initial state; later ones are the plain loop's views
            operands += [line, *svf, *dc, fb]
        for t in operands:
            assert t.is_contiguous(), (k, tuple(t.shape), t.stride())
        assert x.shape[0] == 2 and line.shape[:2] == (2, 2)
