"""Null output device: consumes blocks at wall-clock rate (or instantly).
Copy of ``phonic_tpu/outputs/null.py`` (numpy only).

The test/headless stand-in for a sound card — the analog of running the
reference without an audio backend.  With ``realtime=True`` the writer
blocks so the pump paces itself like a device callback would.
"""

from __future__ import annotations

import time

import numpy as np

from .base import OutputDevice


class NullOutput(OutputDevice):
    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 realtime: bool = False, buffer_secs: float = 0.25):
        self._sr = sample_rate
        self._ch = channels
        self._realtime = realtime
        self._buffer_secs = buffer_secs
        self._pos = 0
        self._t0 = None

    @property
    def sample_rate(self) -> int:
        return self._sr

    @property
    def channel_count(self) -> int:
        return self._ch

    @property
    def sample_position(self) -> int:
        if not self._realtime or self._t0 is None:
            return self._pos
        played = int((time.monotonic() - self._t0) * self._sr)
        return min(self._pos, played)

    def write(self, block) -> None:
        block = self._apply_volume(block)
        n = np.asarray(block).shape[-1]
        if self._realtime:
            if self._t0 is None:
                self._t0 = time.monotonic()
            # block until the device "needs" this data (keep buffer_secs ahead)
            ahead = (self._pos + n) / self._sr - (time.monotonic() - self._t0)
            if ahead > self._buffer_secs:
                time.sleep(ahead - self._buffer_secs)
        self._pos += n

    def close(self) -> None:
        pass
