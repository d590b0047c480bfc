"""Ring-buffer delay lines and the block-feedback decomposition (port of
``phonic_tpu/ops/ring.py``).

Behavioural spec: reference src/utils/dsp/delay.rs (InterpolatedDelayLine:
fractional linear-interp reads, power-of-two masked ring).

A feedback delay's written sample depends on earlier outputs, which is
sequential, but the dependency latency equals the delay length D: writes
inside a span of B <= D-1 samples never feed their own reads.  So a block
processes as a loop over sub-blocks of B samples, each fully vectorised.
The effects keep their delay lines as windows (ops/chrono.py); the ring is
the reference's own layout, kept for callers of the JAX package's names.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Ring(NamedTuple):
    buf: torch.Tensor  # [channels, R] (R = power of two)
    wpos: torch.Tensor  # int32, total frames written mod 2**30


def ring_init(channels: int, min_size: int, dtype=torch.float32,
              device="cpu") -> Ring:
    r = 1
    while r < min_size:
        r *= 2
    return Ring(torch.zeros((channels, r), dtype=dtype, device=device),
                torch.zeros((), dtype=torch.int32, device=device))


def ring_read_frac(ring: Ring, offsets) -> torch.Tensor:
    """Linear-interpolated read at ``wpos - offsets`` (reference
    delay.rs:108-141: read_pos = write_pos - delay).  offsets: [...]
    float >= 0.  Returns [channels, ...].  ``wpos`` is reduced mod R
    before the float conversion, so the position stays exact."""
    r = ring.buf.shape[-1]
    mask = r - 1
    ptype = ring.buf.dtype
    pos = (ring.wpos & mask).to(ptype) - torch.as_tensor(
        offsets, device=ring.buf.device).to(ptype)
    ip = torch.floor(pos)
    frac = pos - ip
    i1 = ip.to(torch.int64) & mask
    i2 = (i1 + 1) & mask
    v1 = ring.buf[:, i1]
    v2 = ring.buf[:, i2]
    return v1 + (v2 - v1) * frac


def ring_write_block(ring: Ring, x: torch.Tensor) -> Ring:
    """Append [channels, B] frames (out of place)."""
    r = ring.buf.shape[-1]
    b = x.shape[-1]
    idx = (ring.wpos.to(torch.int64) + torch.arange(
        b, device=ring.buf.device)) & (r - 1)
    buf = ring.buf.index_copy(-1, idx, x.to(ring.buf.dtype))
    return Ring(buf, (ring.wpos + b) & (2**30 - 1))


def pick_subblock(min_delay_samples: float, block_frames: int,
                  cap: int = 2048) -> int:
    """Largest power-of-two sub-block B with B + 1 <= min delay, dividing
    block_frames; at least 1."""
    b = 1
    while (
        b * 2 + 1 <= int(min_delay_samples)
        and b * 2 <= cap
        and block_frames % (b * 2) == 0
    ):
        b *= 2
    return b
