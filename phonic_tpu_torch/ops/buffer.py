"""Planar buffer utilities (port of ``phonic_tpu/ops/buffer.py``; the slice
needs only the channel remap).

Behavioural spec: reference src/utils/buffer.rs.  The engine's layout is
planar ``[..., channels, frames]``.
"""

from __future__ import annotations

import torch


def remap_channels(x: torch.Tensor, out_channels: int) -> torch.Tensor:
    """Channel-layout conversion of ``[..., in_ch, n]`` (reference:
    src/utils/buffer.rs:183-266): mono->N duplicates into the first two
    channels, N->mono averages the first two, otherwise the first two
    channels are copied and extra output channels are zeroed."""
    in_ch = x.shape[-2]
    if in_ch == out_channels:
        return x
    if out_channels == 1:
        return ((x[..., 0, :] + x[..., 1, :]) * 0.5).unsqueeze(-2)
    parts = [x[..., :1, :]] * min(out_channels, 2) if in_ch == 1 else [
        x[..., :min(in_ch, 2, out_channels), :]]
    pad = out_channels - sum(p.shape[-2] for p in parts)
    if pad > 0:
        parts.append(x.new_zeros(x.shape[:-2] + (pad, x.shape[-1])))
    return torch.cat(parts, dim=-2)


def interleave(x: torch.Tensor) -> torch.Tensor:
    """[channels, frames] -> [frames * channels] interleaved."""
    return x.T.reshape(-1)


def deinterleave(x: torch.Tensor, channels: int) -> torch.Tensor:
    """[frames * channels] interleaved -> [channels, frames]."""
    return x.reshape(-1, channels).T


def peak_level(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.amax(torch.abs(x), dim=axis)


def rms_level(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.sqrt(torch.mean(torch.square(x), dim=axis))
