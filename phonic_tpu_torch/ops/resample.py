"""Resampling reads and loop folds (port of ``hermite_read``,
``sinc_table``, ``sinc_read`` and ``loop_fold`` from
``phonic_tpu/ops/resample.py``).

Behavioural spec: reference src/utils/resampler/cubic.rs — 4-point
3rd-order Hermite x-form (Niemitalo, deip.pdf p. 43, :121-142).  Every
output sample's source position is computed analytically, so a speed-
glided, looped read is one gather + polynomial per block.  Out-of-range
taps read zeros (the reference zero-pads at EOF, src/source/resampled.rs:
104-152, and appends a guard frame, src/source/file/buffer.rs:103-105).

The high-quality read is a Kaiser-windowed polyphase sinc: a gather of
32-tap windows and a dot product with interpolated table rows, plain
tensor operations on every device (the JAX package, too, computes it
outside any Pallas kernel).
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
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


@lru_cache(maxsize=32)
def sinc_table(taps: int = 32, phases: int = 512, cutoff: float = 1.0,
               beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc prototype, tabulated per fractional phase.

    Returns float32 numpy [phases + 1, taps]; row p is the FIR for
    fractional position p/phases.  ``cutoff`` (0..1, fraction of the
    *output* Nyquist) is ~1/ratio when downsampling, for anti-aliasing.
    The cached array is shared: callers copy it to their device and do not
    write to it."""
    half = taps // 2
    # tap k of phase p reads input[floor(pos) - half + 1 + k]; its distance
    # to the read position is (k - half + 1 - p/phases)
    p = np.arange(phases + 1)[:, None] / phases
    k = np.arange(taps)[None, :]
    x = k - half + 1.0 - p  # tap distance to the read position, in [-half, half]
    window = np.kaiser(2 * half * phases + 1, beta)
    wi = np.clip(np.round(x * phases).astype(np.int64) + half * phases, 0,
                 len(window) - 1)
    h = cutoff * np.sinc(cutoff * x) * window[wi]
    h /= h.sum(axis=1, keepdims=True)  # unity DC gain per phase
    table = h.astype(np.float32)
    table.flags.writeable = False
    return table


def sinc_read(buf: torch.Tensor, positions: torch.Tensor, table: torch.Tensor,
              fill: float = 0.0) -> torch.Tensor:
    """Bandlimited read of fractional ``positions`` with a polyphase table
    from :func:`sinc_table` (on ``buf``'s device); linear interpolation
    between adjacent phase rows gives a continuously variable fractional
    delay.

    buf: [..., C, frames]; positions: float32 [..., n] (buf's leading
    dims).  Taps outside [0, frames) read ``fill``.  Returns [..., C, n].
    The [..., C, n, taps] window tensor is the one large intermediate: it
    is masked and weighted in place."""
    frames = buf.shape[-1]
    taps = table.shape[1]
    phases = table.shape[0] - 1
    half = taps // 2

    pos = positions.to(torch.float32)
    k = torch.floor(pos)
    frac = pos - k
    ki = k.to(torch.int64)

    ph = frac * phases
    p0 = torch.floor(ph)
    pf = (ph - p0).to(buf.dtype)[..., None]
    p0 = p0.to(torch.int64).clamp(0, phases)
    h = table[p0] * (1.0 - pf) + table[(p0 + 1).clamp(max=phases)] * pf

    # gather [..., C, n, taps] input windows
    idx = ki[..., None] + torch.arange(-half + 1, taps - half + 1,
                                       device=buf.device)
    valid = (idx >= 0) & (idx < frames)
    lead, n = idx.shape[:-2], idx.shape[-2]
    chans = buf.shape[-2]
    flat = idx.clamp(0, frames - 1).reshape(lead + (1, n * taps))
    v = torch.gather(buf, -1, flat.expand(lead + (chans, n * taps)))
    v = v.view(lead + (chans, n, taps))
    v.masked_fill_(~valid[..., None, :, :], fill)
    v.mul_(h[..., None, :, :])
    return v.sum(dim=-1)


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
