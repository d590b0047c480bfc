"""Waveform display helpers (a copy of ``phonic_tpu/ops/waveform.py``;
reference: src/utils/waveform.rs) —
min/max-downsampled plot data for UIs."""

from __future__ import annotations

import numpy as np


def mixed_down(audio, buckets: int):
    """planar [ch, frames] (or [frames]) -> (mins[buckets], maxs[buckets])
    of the channel-mixed signal."""
    audio = np.asarray(audio)
    mono = audio.mean(axis=0) if audio.ndim == 2 else audio
    return _minmax(mono, buckets)


def multi_channel(audio, buckets: int):
    """-> list of (mins, maxs) per channel."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    return [_minmax(ch, buckets) for ch in audio]


def _minmax(x, buckets: int):
    n = len(x)
    if n == 0:
        z = np.zeros(buckets, np.float32)
        return z, z
    edges = np.linspace(0, n, buckets + 1).astype(np.int64)
    mins = np.empty(buckets, np.float32)
    maxs = np.empty(buckets, np.float32)
    for b in range(buckets):
        seg = x[edges[b]:max(edges[b + 1], edges[b] + 1)]
        mins[b] = seg.min()
        maxs[b] = seg.max()
    return mins, maxs
