"""The chorus's feedback line: the loop of ``ChorusEffect`` that reads its
delay line (port of the ``lax.scan`` in ``phonic_tpu/effects/chorus.py``).

For every lane and channel, sample t reads the line at ``t - pos[t]`` (a
linear-interpolated read, :func:`chrono.read_frac_win`), which is the wet
output, and writes ``filtered[t] + wet[t] * feedback[t]`` into the line.
Channels never couple.  Everything that does not read the line (the input
SVF, the LFOs, the read positions, the dry/wet mix) stays in the effect,
vectorised over the block; this module takes its per-sample streams.

Routing is by the device of the tensors:

- CUDA tensors run the hand-written kernel in ``csrc/chorus.cu``
  (:func:`line_kernel`), one launch per block, always, or raise;
- CPU tensors run :func:`line_plain`, a loop over sub-blocks of ``b``
  samples, each read from the window before it and rolled in after.

Every read position must lie in ``[b + 1, W - 2]`` samples (``W`` the
window): then no sub-block reads its own writes, and nothing sums over
samples, so any sub-blocks of at most ``b`` give the same result bit for
bit.
"""

from __future__ import annotations

import torch

from .. import kernels, tracing
from . import chrono

# the kernel keeps a lane's window in shared memory: at most this many
# samples (227 KB, an H100's largest per block)
MAX_WINDOW = 227 * 1024 // 4


def line_plain(pos, filtered, feedback, win, b: int):
    """Plain version of :func:`line_kernel`: a loop over sub-blocks of
    ``b`` samples (``lax.scan`` in the JAX package); a sub-block shorter
    than the shortest delay never reads its own writes, so each step reads
    the window, then rolls its writes in."""
    n = pos.shape[-1]
    wets = []
    for t0 in range(0, n, b):
        d = chrono.read_frac_win(win, pos[..., t0:t0 + b])  # [G, 2, B]
        win = chrono.roll(
            win, filtered[..., t0:t0 + b] + d * feedback[..., t0:t0 + b])
        wets.append(d)
    return torch.cat(wets, dim=-1), win


def line_kernel(pos, filtered, feedback, win, b: int):
    """Kernel 9 (``csrc/chorus.cu``): the block in one launch.  The read
    positions ``pos`` and the filtered input ``filtered`` [G, 2, n], the
    feedback ``feedback`` [G, 1, n] (both channels') and the line's window
    ``win`` [G, 2, W], newest sample last; all contiguous float32 CUDA
    tensors on one card.  The kernel's tiles are at most ``b`` samples.
    Returns (wet [G, 2, n], new window)."""
    kernels.require(pos, "chorus positions", ndim=3)
    g, ch, n = pos.shape
    if ch != 2:
        raise ValueError(f"chorus positions: {ch} channels, expected 2")
    dev = pos.device
    for t, what, shape in ((filtered, "chorus input", (g, 2, n)),
                           (feedback, "chorus feedback", (g, 1, n))):
        kernels.require(t, what, ndim=3, device=dev)
        if tuple(t.shape) != shape:
            raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                             f"{shape}")
    kernels.require(win, "chorus window", ndim=3, device=dev)
    w = win.shape[-1]
    if win.shape[:2] != (g, 2) or not 3 <= w <= MAX_WINDOW:
        raise ValueError(f"chorus window: shape {tuple(win.shape)}, "
                         f"expected ({g}, 2, 3..{MAX_WINDOW})")
    if not 1 <= b <= n or not 0 < g <= 32767 or n + 2 * w >= 2 ** 31:
        raise ValueError(f"chorus: sub-block {b} for {n} samples, {g} "
                         f"lanes, a window of {w}")
    wet = torch.empty_like(pos)
    new_win = torch.empty_like(win)
    err = kernels.library().phonic_chorus(
        dev.index, pos.data_ptr(), filtered.data_ptr(), feedback.data_ptr(),
        win.data_ptr(), wet.data_ptr(), new_win.data_ptr(), g, n, w, b,
        kernels.stream_handle(pos))
    kernels.check(err, "chorus")
    tracing.count("kernel.chorus")
    return wet, new_win


def line(pos, filtered, feedback, win, b: int):
    """One block of the feedback line, ``(wet, win)``: the kernel for CUDA
    tensors, made contiguous first (the plain version's window may be a
    view), the plain version for CPU ones."""
    if pos.is_cuda:
        return line_kernel(*(t.contiguous() for t in (
            pos, filtered, feedback, win)), b)
    return line_plain(pos, filtered, feedback, win, b)
