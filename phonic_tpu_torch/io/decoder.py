"""Audio file decoding front-end: AudioFileBuffer / AudioFileInfo.

Behavioural spec: reference src/source/file/buffer.rs (fully decoded planar
buffer + loop range + guard frame), src/source/file/info.rs (metadata-only
probe), src/source/file/decoder.rs (format probing / packet decode).

The reference decodes via the symphonia crate (wav/aiff/flac/mp3/ogg/alac);
here WAV, AIFF, FLAC and ALAC are decoded natively (NumPy spec decoders with
C hot loops, io/flac.py + io/alac.py + csrc/flacdec.cpp), mp3/ogg delegate
to libmpg123/libvorbisfile via ctypes, and anything else raises a clear
`UnsupportedFormatError` carrying the detected format — the decode plugin
protocol (`register_decoder`) lets deployments hook in ffmpeg or any other
host decoder without touching the engine.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from . import wav as wav_io
from ..errors import MediaFileError, UnsupportedFormatError


@dataclasses.dataclass
class AudioFileInfo:
    """Metadata-only probe (reference: src/source/file/info.rs)."""

    path: str
    sample_rate: int
    channels: int
    frames: int
    loops: list[wav_io.LoopInfo]

    @property
    def duration_secs(self) -> float:
        return self.frames / float(self.sample_rate)


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

    @classmethod
    def from_file(cls, path) -> "AudioFileBuffer":
        data, info = decode_file(path)
        loop_range = None
        loop_mode = "forward"
        if info.loops:
            lp = info.loops[0]
            # RIFF smpl loop end is inclusive -> half-open range
            loop_range = (lp.start, min(lp.end + 1, data.shape[1]))
            loop_mode = "pingpong" if lp.mode == wav_io.LOOP_PINGPONG else "forward"
        return cls.from_array(data, info.sample_rate, loop_range, loop_mode)


_DECODERS: dict[str, Callable] = {}


def register_decoder(extension: str, fn: Callable):
    """Register a host decoder: fn(path) -> (float32 [ch, frames], sample_rate)."""
    _DECODERS[extension.lower().lstrip(".")] = fn


def _sniff_format(path: Path) -> str:
    try:
        head = path.open("rb").read(12)
    except OSError as e:
        raise MediaFileError(f"cannot open {path}: {e}") from e
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"FORM" and head[8:12] in (b"AIFF", b"AIFC"):
        return "aiff"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:4] == b"OggS":
        return "ogg"
    if head[4:8] == b"ftyp":
        return "m4a"
    if head[:3] == b"ID3" or (len(head) > 1 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0):
        return "mp3"
    return path.suffix.lstrip(".").lower() or "unknown"


def decode_file(path):
    """Decode any supported file to (float32 [channels, frames], AudioFileInfo)."""
    p = Path(path)
    fmt = _sniff_format(p)
    if fmt == "wav":
        data, winfo = wav_io.read_wav(p)
        info = AudioFileInfo(str(p), winfo.sample_rate, winfo.channels, winfo.frames, winfo.loops)
        return data, info
    if fmt == "aiff":
        data, sr = _read_aiff(p)
        info = AudioFileInfo(str(p), sr, data.shape[0], data.shape[1], [])
        return data, info
    if fmt == "flac":
        from .flac import read_flac
        data, sr = read_flac(p)
        info = AudioFileInfo(str(p), sr, data.shape[0], data.shape[1], [])
        return data, info
    if fmt == "mp3" and "mp3" not in _DECODERS:
        from .mp3 import read_mp3
        data, sr = read_mp3(p)
        info = AudioFileInfo(str(p), sr, data.shape[0], data.shape[1], [])
        return data, info
    if fmt == "ogg" and "ogg" not in _DECODERS:
        from .vorbis import read_vorbis
        data, sr = read_vorbis(p)
        info = AudioFileInfo(str(p), sr, data.shape[0], data.shape[1], [])
        return data, info
    if fmt == "m4a" and "m4a" not in _DECODERS:
        from .alac import read_alac
        data, sr = read_alac(p)
        info = AudioFileInfo(str(p), sr, data.shape[0], data.shape[1], [])
        return data, info
    if fmt in _DECODERS:
        data, sr = _DECODERS[fmt](p)
        data = np.asarray(data, np.float32)
        info = AudioFileInfo(str(p), sr, data.shape[0], data.shape[1], [])
        return data, info
    raise UnsupportedFormatError(
        f"{p}: format '{fmt}' has no built-in decoder; register one with "
        f"phonic_tpu_torch.io.register_decoder({fmt!r}, fn)"
    )


def file_info(path) -> AudioFileInfo:
    """Metadata-only probe (reference: src/source/file/info.rs) — reads
    headers/sample-tables, not audio, for every built-in format."""
    p = Path(path)
    fmt = _sniff_format(p)
    if fmt == "wav":
        winfo = wav_io.read_wav_info(p)
        return AudioFileInfo(str(p), winfo.sample_rate, winfo.channels, winfo.frames, winfo.loops)
    if fmt in ("aiff", "flac", "mp3", "ogg", "m4a") and fmt not in _DECODERS:
        from .chunked import open_chunked
        r = open_chunked(p)
        try:
            return AudioFileInfo(str(p), r.sample_rate, r.channels, r.frames,
                                 r.loops)
        finally:
            r.close()
    data, info = decode_file(p)
    return info


def _read_f80(b: bytes) -> float:
    """80-bit IEEE 754 extended float (AIFF sample rate field)."""
    exp = ((b[0] & 0x7F) << 8) | b[1]
    mant = int.from_bytes(b[2:10], "big")
    if exp == 0 and mant == 0:
        return 0.0
    sign = -1.0 if b[0] & 0x80 else 1.0
    return sign * mant * 2.0 ** (exp - 16383 - 63)


def _read_aiff(path: Path):
    data = path.read_bytes()
    if data[:4] != b"FORM":
        raise MediaFileError(f"{path}: not an AIFF file")
    pos = 12
    channels = frames = bits = 0
    sr = 0.0
    audio = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from(">I", data, pos + 4)
        if cid == b"COMM":
            channels, frames, bits = struct.unpack_from(">hIh", data, pos + 8)
            sr = _read_f80(data[pos + 16 : pos + 26])
        elif cid == b"SSND":
            (offset, _block) = struct.unpack_from(">II", data, pos + 8)
            audio = data[pos + 16 + offset : pos + 8 + size]
        pos += 8 + size + (size & 1)
    if audio is None or channels == 0:
        raise MediaFileError(f"{path}: missing SSND/COMM chunk")
    if bits == 16:
        x = np.frombuffer(audio, ">i2").astype(np.float32) / 32768.0
    elif bits == 8:
        x = np.frombuffer(audio, "i1").astype(np.float32) / 128.0
    elif bits == 24:
        b = np.frombuffer(audio, np.uint8).reshape(-1, 3)
        vals = (
            (b[:, 0].astype(np.uint32) << 16)
            | (b[:, 1].astype(np.uint32) << 8)
            | b[:, 2].astype(np.uint32)
        ).astype(np.int32)
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif bits == 32:
        x = np.frombuffer(audio, ">i4").astype(np.float32) / float(1 << 31)
    else:
        raise UnsupportedFormatError(f"{path}: unsupported AIFF bit depth {bits}")
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).T.copy(), int(round(sr))
