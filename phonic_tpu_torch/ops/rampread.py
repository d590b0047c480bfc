"""Batched 4-point Hermite read of ramp positions (port of
``phonic_tpu/ops/rampread.py``).

Lane b of a batch reads source ``smap[b]`` of a table of planar buffers at
fractional positions.  On the TPU this was a Pallas kernel over packed,
overlapped 124-stride rows with one-hot MXU tap selection, because gathers
ran at scalar rate there.  On the GPU a gather is cheap: the buffers stay
planar and :func:`ramp_read` launches ``csrc/rampread.cu`` for CUDA tensors
(a warp per 128 consecutive outputs of a lane, the grid sized to the card);
CPU tensors take the plain version, :func:`ramp_read_plain`
(``hermite_read`` over ``buffers[smap]``).

The read has no window contract: any positions, including loop, pingpong
and wrap jumps, read exactly.  Callers still clamp per-sample steps to the
JAX package's step bound so the positions match it.
"""

from __future__ import annotations

import torch

from .. import kernels
from .resample import hermite_read

# kernel launch count (one per wrapper call that launched its kernel)
launches = 0


def ramp_read_plain(buffers: torch.Tensor, smap: torch.Tensor,
                    positions: torch.Tensor) -> torch.Tensor:
    """Plain version: ``hermite_read`` of ``buffers[smap]`` [B, ch, F] at
    ``positions`` [B, N].  Returns [B, ch, N]."""
    return hermite_read(buffers[smap.long()], positions[:, None, :])


def ramp_read(buffers: torch.Tensor, smap: torch.Tensor,
              positions: torch.Tensor) -> torch.Tensor:
    """Batched 4-point Hermite read.

    buffers: [S, ch, F] float32 planar source table (taps outside [0, F)
    read 0; a zero guard frame per buffer keeps reads past the end silent).
    smap: [B] int32 — which buffer each lane reads (an index outside
    [0, S) reads silence on the CUDA path).
    positions: [B, N] float32 fractional frame positions (NaN reads
    silence on the CUDA path).
    Returns [B, ch, N] float32."""
    global launches
    if not positions.is_cuda:
        return ramp_read_plain(buffers, smap, positions)
    dev = positions.device
    kernels.require(buffers, "ramp_read buffers", ndim=3, device=dev)
    kernels.require(smap, "ramp_read smap", ndim=1, dtype=torch.int32,
                    device=dev)
    kernels.require(positions, "ramp_read positions", ndim=2, device=dev)
    s, ch, frames = buffers.shape
    b, n = positions.shape
    if smap.shape[0] != b:
        raise ValueError(f"ramp_read: smap has {smap.shape[0]} lanes, "
                         f"positions {b}")
    # the sizes pass as C ints, with room for the kernel's index arithmetic
    if b == 0 or max(s, ch, frames, b, n) >= 2**30:
        raise ValueError(f"ramp_read: unsupported sizes S={s} ch={ch} "
                         f"F={frames} B={b} N={n}")
    out = torch.empty((b, ch, n), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = kernels.library().phonic_ramp_read(
        dev.index, buffers.data_ptr(), smap.data_ptr(), positions.data_ptr(),
        out.data_ptr(), s, ch, frames, b, n, kernels.stream_handle(positions))
    kernels.check(err, "ramp_read")
    launches += 1
    return out
