"""4-point Hermite resampling read and loop folds (port of
``hermite_read`` and ``loop_fold`` from ``phonic_tpu/ops/resample.py``).

Behavioural spec: reference src/utils/resampler/cubic.rs — 4-point
3rd-order Hermite x-form (Niemitalo, deip.pdf p. 43, :121-142).  Every
output sample's source position is computed analytically, so a speed-
glided, looped read is one gather + polynomial per block.  Out-of-range
taps read zeros (the reference zero-pads at EOF, src/source/resampled.rs:
104-152, and appends a guard frame, src/source/file/buffer.rs:103-105).
"""

from __future__ import annotations

import math

import torch


def length_bucket(frames: int) -> int:
    """Coarse log2 length bucket for batch grouping: lanes in a group
    zero-pad to the group's longest buffer.  Everything under 64k frames
    shares bucket 0; beyond that, log2 buckets bound the waste to <2x."""
    return max(int(frames).bit_length() - 16, 0)


def speed_bucket(max_step: float) -> int:
    """Power-of-two bucket exponent for a per-sample position step bound:
    smax = 2**bucket >= max_step.  File sources and samplers clamp their
    steps to smax, as the JAX package does for its windowed reads, so
    positions match."""
    m = max(float(max_step), 1e-6)
    # exact powers of two stay in their own bucket (smax bounds inclusive)
    return int(min(max(math.ceil(math.log2(m) - 1e-9), 0), 6))


def hermite_read(buf: torch.Tensor, positions: torch.Tensor,
                 fill: float = 0.0) -> torch.Tensor:
    """Read fractional ``positions`` from ``buf`` with 4-point Hermite
    interpolation.

    buf: [..., frames] (channels lead); positions: float32 broadcastable to
    buf's batch dims + [n].  Taps outside [0, frames-1] read ``fill``.
    Returns buf's batch dims + [n]."""
    frames = buf.shape[-1]
    pos = positions.to(torch.float32)
    k = torch.floor(pos)
    frac = (pos - k).to(buf.dtype)
    ki = k.to(torch.int64)
    shape = torch.broadcast_shapes(buf.shape[:-1] + (1,), pos.shape)
    buf = buf.expand(shape[:-1] + (frames,))

    def tap(offset):
        idx = ki + offset
        valid = (idx >= 0) & (idx < frames)
        v = torch.gather(buf, -1, idx.clamp(0, frames - 1).expand(shape))
        return torch.where(valid, v, fill)

    ym1, y0, y1, y2 = tap(-1), tap(0), tap(1), tap(2)
    # Niemitalo x-form coefficients (src/utils/resampler/cubic.rs:128-141)
    c0 = y0
    c1 = (y1 - ym1) * 0.5
    c2 = ym1 - y0 * 2.5 + y1 * 2.0 - y2 * 0.5
    c3 = (y2 - ym1) * 0.5 + (y0 - y1) * 1.5
    return ((c3 * frac + c2) * frac + c1) * frac + c0


def loop_fold(positions: torch.Tensor, loop_start, loop_end,
              mode: str = "forward") -> torch.Tensor:
    """Fold linear positions into a loop range.

    forward:   start + (p - start) mod len        (wraps back to loop start)
    pingpong:  triangle fold between start and end.
    Positions before loop_start pass through unchanged (first pass).
    ``torch.remainder`` is floored modulo, as ``jnp.mod``."""
    p = positions.to(torch.float32)
    start = torch.as_tensor(loop_start, dtype=torch.float32, device=p.device)
    end = torch.as_tensor(loop_end, dtype=torch.float32, device=p.device)
    length = torch.clamp(end - start, min=1e-6)
    rel = p - start
    if mode == "forward":
        folded = start + torch.remainder(rel, length)
    elif mode == "pingpong":
        cycle = torch.remainder(rel, 2.0 * length)
        folded = start + torch.where(cycle < length, cycle, 2.0 * length - cycle)
    else:
        raise ValueError(f"unknown loop mode {mode!r}")
    return torch.where(p < start, p, folded)
