"""Decoded audio buffers (port of ``AudioFileBuffer`` from
``phonic_tpu/io/decoder.py``).

Behavioural spec: reference src/source/file/buffer.rs (fully decoded planar
buffer + loop range + guard frame).  File decoding is not ported yet; build
buffers from arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..errors import MediaFileError


@dataclasses.dataclass
class AudioFileBuffer:
    """Fully decoded planar float32 audio + specs + optional loop range
    (reference: src/source/file/buffer.rs).  One zero guard frame is
    appended for interpolating resamplers (buffer.rs:103-105) — ``frames``
    excludes it."""

    data: np.ndarray  # float32 [channels, frames + 1]
    sample_rate: int
    loop_range: Optional[tuple[int, int]] = None  # [start, end) frames
    loop_mode: str = "forward"

    @property
    def channels(self) -> int:
        return self.data.shape[0]

    @property
    def frames(self) -> int:
        return self.data.shape[1] - 1  # exclude guard frame

    @classmethod
    def from_array(cls, data, sample_rate: int, loop_range=None, loop_mode="forward"):
        data = np.asarray(data, np.float32)
        if data.ndim == 1:
            data = data[None, :]
        if data.shape[0] > data.shape[1] and data.shape[1] <= 32:
            raise MediaFileError("expected planar [channels, frames] audio")
        guard = np.zeros((data.shape[0], 1), np.float32)
        return cls(np.concatenate([data, guard], axis=1), sample_rate, loop_range, loop_mode)
