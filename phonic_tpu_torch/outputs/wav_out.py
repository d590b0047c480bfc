"""Offline WAV output device with streaming writes.

Behavioural spec: reference src/output/wav.rs — pulls the root source in
blocks and writes 32-bit-float WAV incrementally (hound's WavWriter),
finalizing when the source exhausts or the configured duration elapses.
Here blocks are *pushed* by the caller (``play_file.render_file``); each
block is encoded
and appended to the file immediately (constant memory for arbitrarily long
renders) and the RIFF/data sizes are patched on ``close()``.
"""

from __future__ import annotations

import struct

import numpy as np

from ..io.wav import encode_wav_samples, read_wav, wav_header
from .base import OutputDevice


class WavOutput(OutputDevice):
    def __init__(self, path, sample_rate: int = 48000, channels: int = 2,
                 bits: int = 32, float_format: bool = True):
        self.path = path
        self._sr = sample_rate
        self._ch = channels
        self._bits = bits
        self._float = float_format
        self._pos = 0
        self._data_bytes = 0
        self._file = None
        self._closed = False

    @property
    def sample_rate(self) -> int:
        return self._sr

    @property
    def channel_count(self) -> int:
        return self._ch

    @property
    def sample_position(self) -> int:
        return self._pos

    def _ensure_open(self):
        if self._file is None:
            self._file = open(self.path, "wb")
            # placeholder sizes, patched in close()
            self._file.write(wav_header(self._sr, self._ch, self._bits,
                                        self._float, 0))

    def write(self, block) -> None:
        if self._closed:
            raise RuntimeError("WavOutput already closed")
        block = np.asarray(self._apply_volume(block), np.float32)
        self._ensure_open()
        payload = encode_wav_samples(block, self._bits, self._float)
        self._file.write(payload)
        self._data_bytes += len(payload)
        self._pos += block.shape[-1]

    def audio(self) -> np.ndarray:
        """Rendered audio so far (reads back the file; test/debug helper)."""
        if self._file is not None and not self._closed:
            self._file.flush()
            self._patch_sizes()
        try:
            return read_wav(self.path)[0]
        except (FileNotFoundError, ValueError):
            return np.zeros((self._ch, 0), np.float32)

    def _patch_sizes(self):
        header = wav_header(self._sr, self._ch, self._bits, self._float,
                            self._data_bytes)
        end = self._file.tell()
        self._file.seek(0)
        self._file.write(header)
        self._file.seek(end)

    def close(self) -> None:
        if not self._closed:
            self._ensure_open()
            if self._data_bytes & 1:
                self._file.write(b"\x00")
            self._patch_sizes()
            self._file.close()
            self._closed = True
