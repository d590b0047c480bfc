"""The feedback delay's block: the loop of ``DelayEffect`` that reads the
fed-back line (port of the ``lax.scan`` in ``phonic_tpu/effects/delay.py``).

For every lane and channel, sample t reads the line at ``t - delay[t]``
(a linear-interpolated read, ``ops/chrono.read_frac_win``), filters it with
the TPT SVF, saturates it, blocks DC, clamps it to +-4 (the wet output) and
writes ``x[t] + clean[t-1] * feedback[t]`` into the line (stereo; ping-pong
crosses the channels).  Everything that does not read the line (the LFO,
the delay times, the coefficients, the output mix) stays in the effect,
vectorised over the block; this module takes their per-sample streams.

Routing is by the device of the tensors:

- CUDA tensors run the hand-written kernel in ``csrc/delay.cu``
  (:func:`feedback_loop_kernel`), one launch per block, always, or raise;
- CPU tensors run :func:`feedback_loop_plain`, a loop over sub-blocks of
  ``b`` samples, each read from the window before it and rolled in after.

Every delay must lie in ``[b + 1, W - 2]`` samples (``W`` the window):
then no sub-block reads its own writes, and both versions give the same
result whatever the sub-blocks, up to the float32 association of the scans.
"""

from __future__ import annotations

import torch

from .. import kernels, tracing
from . import chrono, filters
from .filters import DcState, TptCoefficients, TptState


def saturate(x, drive):
    """tanh-approx soft clip x(27+x^2)/(27+9x^2), gain-scaled by drive
    (reference: delay.rs:69-79)."""
    gain = 1.0 + drive * 4.0
    xg = x * gain
    x2 = xg * xg
    out = xg * (27.0 + x2) / (27.0 + 9.0 * x2) / torch.sqrt(gain)
    return torch.where(drive < 0.001, x, out)


def feedback_loop_plain(x, line, svf: TptState, dc: DcState, fb,
                        delay_samples, feedback, drive,
                        coefs: TptCoefficients, ping_pong, dc_r: float,
                        b: int, dtype=torch.float32):
    """Plain version of :func:`feedback_loop_kernel`: a loop over sub-blocks
    of ``b`` samples (``lax.scan`` in the JAX package); each step reads the
    window, then rolls its writes in."""
    n = x.shape[-1]
    win, fb_state = line, fb
    wets = []
    for t0 in range(0, n, b):
        sl = slice(t0, t0 + b)
        fb_j = feedback[:, sl]
        delayed = chrono.read_frac_win(win, delay_samples[:, None, sl])
        svf, filtered = filters.tpt_process(
            svf, delayed, TptCoefficients(*(c[..., sl] for c in coefs)),
            dtype=dtype)
        saturated = saturate(filtered, drive[:, None, sl])
        dc, blocked = filters.dc_process(dc, saturated, dc_r, dtype=dtype)
        clean = torch.clamp(blocked, -4.0, 4.0)  # [G, 2, B]

        # previous-sample clean values (the feedback source)
        prev = torch.cat([fb_state[..., None], clean[..., :-1]], dim=-1)
        x_j = x[..., sl]
        mono = (x_j[:, 0] + x_j[:, 1]) * 0.5
        # stereo: own-channel feedback; pingpong: cross-channel
        l_in = torch.where(ping_pong, mono + prev[:, 1] * fb_j,
                           x_j[:, 0] + prev[:, 0] * fb_j)
        r_in = torch.where(ping_pong, prev[:, 0] * fb_j,
                           x_j[:, 1] + prev[:, 1] * fb_j)
        win = chrono.roll(win, torch.stack([l_in, r_in], dim=1))
        fb_state = clean[..., -1]
        wets.append(clean)
    return torch.cat(wets, dim=-1), win, svf, dc, fb_state


def _lanes(t: torch.Tensor, what: str, shape, device) -> None:
    kernels.require(t, what, ndim=len(shape), device=device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def feedback_loop_kernel(x, line, svf: TptState, dc: DcState, fb,
                         delay_samples, feedback, drive,
                         coefs: TptCoefficients, ping_pong, dc_r: float,
                         b: int, dtype=torch.float32):
    """Kernel 7 (``csrc/delay.cu``): the block in one launch.  ``x`` [G, 2,
    n] and the line's window ``line`` [G, 2, W]; the states [G, 2]; the
    per-sample streams [G, n] (coefficients [G, n] or [G, 1, n]);
    ``ping_pong`` a bool per lane ([G] or [G, 1]).  All contiguous float32
    CUDA tensors on one card.  Returns (wet [G, 2, n], new window,
    new SVF state, new DC state, new feedback state)."""
    if dtype != torch.float32:
        raise TypeError(f"delay: the kernel runs float32, not {dtype}")
    kernels.require(x, "delay input", ndim=3)
    g, ch, n = x.shape
    if ch != 2:
        raise ValueError(f"delay input: {ch} channels, expected 2")
    dev = x.device
    kernels.require(line, "delay line", ndim=3, device=dev)
    w = line.shape[-1]
    if line.shape[:2] != (g, 2) or w < 3:
        raise ValueError(f"delay line: shape {tuple(line.shape)}, expected "
                         f"({g}, 2, W >= 3)")
    states = (svf.ic1, svf.ic2, dc.y1, dc.x1, fb)
    for t, what in zip(states, ("svf ic1", "svf ic2", "dc y1", "dc x1",
                                "feedback state")):
        _lanes(t, f"delay {what}", (g, 2), dev)
    streams = (delay_samples, feedback, drive) + tuple(
        c.squeeze(1) if c.dim() == 3 else c for c in coefs)
    for t, what in zip(streams, ("delay times", "feedback", "drive", "a1",
                                 "a2", "a3", "m0", "m1", "m2")):
        _lanes(t, f"delay {what}", (g, n), dev)
    kernels.require(ping_pong, "delay ping-pong", ndim=ping_pong.dim(),
                    dtype=torch.bool, device=dev)
    if ping_pong.numel() != g:
        raise ValueError(f"delay ping-pong: {ping_pong.numel()} flags, "
                         f"expected {g}")
    if not 1 <= b <= n or not 0 < g <= 65535 or n + 2 * w >= 2 ** 31:
        raise ValueError(f"delay: sub-block {b} for {n} samples, {g} lanes, "
                         f"a window of {w}")
    wet = torch.empty_like(x)
    new_line = torch.empty_like(line)
    st = torch.empty((5, g, 2), dtype=torch.float32, device=dev)
    err = kernels.library().phonic_delay(
        dev.index, x.data_ptr(), line.data_ptr(),
        *(t.data_ptr() for t in states + streams), ping_pong.data_ptr(),
        float(dc_r), wet.data_ptr(), new_line.data_ptr(), st.data_ptr(), g,
        n, w, b, kernels.stream_handle(x))
    kernels.check(err, "delay")
    tracing.count("kernel.delay")
    return wet, new_line, TptState(st[0], st[1]), DcState(st[2], st[3]), st[4]


def feedback_loop(x, line, svf: TptState, dc: DcState, fb, delay_samples,
                  feedback, drive, coefs: TptCoefficients, ping_pong,
                  dc_r: float, b: int, dtype=torch.float32):
    """One block of the feedback loop, ``(wet, line, svf, dc, fb)``: the
    kernel for CUDA tensors, the plain version for CPU ones."""
    fn = feedback_loop_kernel if x.is_cuda else feedback_loop_plain
    return fn(x, line, svf, dc, fb, delay_samples, feedback, drive, coefs,
              ping_pong, dc_r, b, dtype)
