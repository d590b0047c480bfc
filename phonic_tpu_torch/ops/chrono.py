"""Rolling-window feedback delay lines (port of ``hist_len``,
``chrono_init``, ``read_frac_win`` and ``roll`` from
``phonic_tpu/ops/chrono.py``).

Behavioural spec: reference src/utils/dsp/delay.rs (InterpolatedDelayLine:
fractional linear-interp reads at ``write_pos - delay``).

A delay line is the window of its last W written samples, newest last.  A
sub-block reads fractional offsets from the window, then :func:`roll`
appends its writes.  The JAX package reads the window with one-hot row
matmuls (exact f32 copies on its chip); here the read is a plain gather,
which picks the identical values.  Windows carry any leading batch dims:
``[..., ch, W]``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

_LANE = 128


class Chrono(NamedTuple):
    hist: torch.Tensor  # [..., channels, H], newest sample last


def hist_len(min_offset: int) -> int:
    """History length: covers reads up to ``min_offset`` (the max read
    offset in samples) plus the lerp partner, rounded up to 128 (the JAX
    package's lane multiple, kept so both packages hold the same window)."""
    need = int(min_offset) + 2
    return -(-need // _LANE) * _LANE


def chrono_init(shape, max_offset: int, dtype=torch.float32,
                device="cpu") -> Chrono:
    """Zeroed window of ``shape + (hist_len(max_offset),)``."""
    return Chrono(torch.zeros(tuple(shape) + (hist_len(max_offset),),
                              dtype=dtype, device=device))


def read_frac_win(win: torch.Tensor, offsets: torch.Tensor) -> torch.Tensor:
    """Linear-interpolated read of the window ``win`` [..., ch, W], which
    holds the last W samples strictly before the current sub-block.
    Output sample j reads window-relative position W + j - offsets[..., j];
    offsets [..., ch, B] (or broadcastable) must satisfy
    B + 1 <= offs <= W - 2.  Returns [..., ch, B]."""
    w = win.shape[-1]
    b = offsets.shape[-1]
    offs = offsets.to(win.dtype)
    # exact split: oi = floor(offs), of = offs - oi (Sterbenz-exact)
    oi = torch.floor(offs)
    of = offs - oi
    is_int = of == 0
    j = torch.arange(b, device=win.device)
    rel = w + j - oi.to(torch.int64) - (~is_int).to(torch.int64)
    frac = torch.where(is_int, of, 1.0 - of)
    rel = rel.expand(win.shape[:-1] + (b,))
    v1 = torch.gather(win, -1, rel)
    v2 = torch.gather(win, -1, rel + 1)
    return v1 + (v2 - v1) * frac


def roll(win: torch.Tensor, writes: torch.Tensor) -> torch.Tensor:
    """Advance the window by one sub-block: drop the oldest B frames and
    append ``writes`` [..., ch, B] as the newest."""
    b = writes.shape[-1]
    return torch.cat([win[..., b:], writes.to(win.dtype)], dim=-1)
