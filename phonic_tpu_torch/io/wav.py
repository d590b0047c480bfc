"""WAV file reading/writing in pure NumPy (host-side I/O edge).

Behavioural spec: the reference decodes via symphonia (wav/aiff/flac/mp3/...,
reference Cargo.toml:46-56) and writes 32-bit-float WAVs via hound
(src/output/wav.rs:117-143).  This module covers RIFF/WAVE with PCM u8/i16/
i24/i32, float32/float64, WAVE_FORMAT_EXTENSIBLE, and the RIFF ``smpl``
loop-chunk the reference parses for sampler loop ranges
(src/source/file/decoder.rs:27-65).

Audio is exchanged as planar float32 ``[channels, frames]`` — the engine's
native layout; interleaving happens only here at the file edge.
"""

from __future__ import annotations

import dataclasses
import struct
from pathlib import Path

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_MS_ADPCM = 0x0002
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_IMA_ADPCM = 0x0011
WAVE_FORMAT_EXTENSIBLE = 0xFFFE

# ---------------------------------------------------------------------------
# ADPCM (reference: symphonia-codec-adpcm via Cargo.toml:46-56).  Blocks are
# independent, so decoding vectorises ACROSS blocks: the per-sample loop runs
# samples_per_block iterations of whole-array NumPy ops.
# ---------------------------------------------------------------------------

_IMA_INDEX_TABLE = np.array(
    [-1, -1, -1, -1, 2, 4, 6, 8, -1, -1, -1, -1, 2, 4, 6, 8], np.int32)
_IMA_STEP_TABLE = np.array([
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767], np.int32)
_MS_ADAPT_TABLE = np.array(
    [230, 230, 230, 230, 307, 409, 512, 614, 768, 614, 512, 409, 307, 230,
     230, 230], np.int32)
_MS_COEFS = np.array(
    [[256, 0], [512, -256], [0, 0], [192, 64], [240, 0], [460, -208],
     [392, -232]], np.int32)

# smpl chunk loop modes (RIFF spec; reference src/source/file/decoder.rs:27-43)
LOOP_FORWARD = 0
LOOP_PINGPONG = 1
LOOP_BACKWARD = 2


@dataclasses.dataclass
class LoopInfo:
    mode: int  # LOOP_FORWARD / LOOP_PINGPONG / LOOP_BACKWARD
    start: int  # frame index, inclusive
    end: int  # frame index, inclusive (RIFF semantics)


@dataclasses.dataclass
class WavInfo:
    sample_rate: int
    channels: int
    frames: int
    bits: int
    format_tag: int
    loops: list[LoopInfo]


def _iter_chunks(data: bytes):
    pos = 12  # past 'RIFF' size 'WAVE'
    n = len(data)
    while pos + 8 <= n:
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield cid, pos + 8, size
        pos += 8 + size + (size & 1)  # chunks are word-aligned


def read_wav_info(path) -> WavInfo:
    data = Path(path).read_bytes()
    return _parse(data, info_only=True)[1]


def read_wav(path) -> tuple[np.ndarray, WavInfo]:
    """Returns (float32 [channels, frames], WavInfo)."""
    data = Path(path).read_bytes()
    return _parse(data, info_only=False)


def _decode_ima_adpcm(raw: bytes, ch: int, block_align: int):
    """IMA/DVI ADPCM (format tag 0x11): 4-byte per-channel block headers
    (predictor i16, step index u8), then channel-interleaved 4-byte nibble
    groups.  Returns interleaved float32 [frames * ch]."""
    data = np.frombuffer(raw, np.uint8)
    nblocks = len(data) // block_align
    if nblocks == 0:
        return np.zeros(0, np.float32)
    blocks = data[: nblocks * block_align].reshape(nblocks, block_align)
    hdr = blocks[:, : 4 * ch].reshape(nblocks, ch, 4).astype(np.int32)
    pred = (hdr[:, :, 0] | (hdr[:, :, 1] << 8)).astype(np.uint16) \
        .astype(np.int16).astype(np.int32)
    index = np.clip(hdr[:, :, 2], 0, 88)
    body = blocks[:, 4 * ch:]
    ngroups = body.shape[1] // (4 * ch)
    body = body[:, : ngroups * 4 * ch].reshape(nblocks, ngroups, ch, 4)
    nib = np.empty((nblocks, ngroups, ch, 8), np.uint8)
    nib[..., 0::2] = body & 0x0F
    nib[..., 1::2] = body >> 4
    codes = nib.transpose(0, 2, 1, 3).reshape(nblocks, ch, ngroups * 8)
    spb = 1 + ngroups * 8
    out = np.empty((nblocks, ch, spb), np.int16)
    out[:, :, 0] = pred.astype(np.int16)
    step = _IMA_STEP_TABLE[index]
    for i in range(ngroups * 8):
        code = codes[:, :, i].astype(np.int32)
        diff = (step >> 3) + np.where(code & 4, step, 0) \
            + np.where(code & 2, step >> 1, 0) \
            + np.where(code & 1, step >> 2, 0)
        pred = np.clip(np.where(code & 8, pred - diff, pred + diff),
                       -32768, 32767)
        index = np.clip(index + _IMA_INDEX_TABLE[code], 0, 88)
        step = _IMA_STEP_TABLE[index]
        out[:, :, i + 1] = pred.astype(np.int16)
    # [nblocks, ch, spb] -> interleaved [nblocks*spb*ch]
    inter = out.transpose(0, 2, 1).reshape(-1).astype(np.float32) / 32768.0
    return inter


def _decode_ms_adpcm(raw: bytes, ch: int, block_align: int):
    """MS ADPCM (format tag 0x02): per-block header (predictor u8, delta
    i16, sample1 i16, sample2 i16 per channel), then channel-interleaved
    nibbles.  Returns interleaved float32 [frames * ch]."""
    data = np.frombuffer(raw, np.uint8)
    nblocks = len(data) // block_align
    if nblocks == 0:
        return np.zeros(0, np.float32)
    blocks = data[: nblocks * block_align].reshape(nblocks, block_align)

    def i16(col):
        return (blocks[:, col].astype(np.int32)
                | (blocks[:, col + 1].astype(np.int32) << 8)) \
            .astype(np.uint16).astype(np.int16).astype(np.int32)

    bpred = np.stack([np.clip(blocks[:, c].astype(np.int32), 0, 6)
                      for c in range(ch)], axis=1)  # [nblocks, ch]
    idelta = np.stack([i16(ch + 2 * c) for c in range(ch)], axis=1)
    s1 = np.stack([i16(3 * ch + 2 * c) for c in range(ch)], axis=1)
    s2 = np.stack([i16(5 * ch + 2 * c) for c in range(ch)], axis=1)
    c1 = _MS_COEFS[bpred, 0]
    c2 = _MS_COEFS[bpred, 1]
    body = blocks[:, 7 * ch:]
    n_nib = body.shape[1] * 2  # hi nibble first
    codes = np.empty((nblocks, n_nib), np.uint8)
    codes[:, 0::2] = body >> 4
    codes[:, 1::2] = body & 0x0F
    # nibbles cycle through channels
    steps = n_nib // ch
    codes = codes[:, : steps * ch].reshape(nblocks, steps, ch)
    spb = 2 + steps
    out = np.empty((nblocks, ch, spb), np.int16)
    out[:, :, 0] = s2.astype(np.int16)
    out[:, :, 1] = s1.astype(np.int16)
    for i in range(steps):
        code = codes[:, i, :].astype(np.int32)
        signed = np.where(code >= 8, code - 16, code)
        predicted = ((s1 * c1 + s2 * c2) >> 8) + signed * idelta
        predicted = np.clip(predicted, -32768, 32767)
        s2 = s1
        s1 = predicted
        idelta = np.maximum((_MS_ADAPT_TABLE[code] * idelta) >> 8, 16)
        out[:, :, i + 2] = predicted.astype(np.int16)
    inter = out.transpose(0, 2, 1).reshape(-1).astype(np.float32) / 32768.0
    return inter


def _parse(data: bytes, info_only: bool):
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    fmt = None
    audio = None
    n_data = 0
    fact_frames = None
    loops: list[LoopInfo] = []
    for cid, off, size in _iter_chunks(data):
        if cid == b"fmt ":
            tag, ch, sr, _br, block_align, bits = struct.unpack_from("<HHIIHH", data, off)
            if tag == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                (sub,) = struct.unpack_from("<H", data, off + 24)
                tag = sub
            fmt = (tag, ch, sr, bits, block_align)
        elif cid == b"fact" and size >= 4:
            (fact_frames,) = struct.unpack_from("<I", data, off)
        elif cid == b"data":
            n_data = min(size, len(data) - off)
            if not info_only:
                audio = data[off : off + n_data]
        elif cid == b"smpl" and size >= 36:
            (n_loops,) = struct.unpack_from("<I", data, off + 28)
            for i in range(n_loops):
                base = off + 36 + i * 24
                if base + 24 > off + size:
                    break
                _ident, mode, start, end, _frac, _count = struct.unpack_from(
                    "<IIIIII", data, base
                )
                loops.append(LoopInfo(mode=mode, start=start, end=end))
    if fmt is None:
        raise ValueError("missing fmt chunk")
    tag, ch, sr, bits, block_align = fmt
    if tag in (WAVE_FORMAT_IMA_ADPCM, WAVE_FORMAT_MS_ADPCM):
        nblocks = n_data // block_align if block_align else 0
        if tag == WAVE_FORMAT_IMA_ADPCM:
            spb = ((block_align - 4 * ch) // (4 * ch)) * 8 + 1
        else:
            spb = (block_align - 7 * ch) * 2 // ch + 2
        frames = nblocks * spb
        if fact_frames is not None:
            frames = min(frames, fact_frames)
        info = WavInfo(sample_rate=sr, channels=ch, frames=frames, bits=bits,
                       format_tag=tag, loops=loops)
        if info_only:
            return None, info
        dec = _decode_ima_adpcm if tag == WAVE_FORMAT_IMA_ADPCM \
            else _decode_ms_adpcm
        inter = dec(audio, ch, block_align)
        frames = min(frames, len(inter) // ch)
        x = inter[: frames * ch].reshape(frames, ch).T.copy()
        info.frames = frames
        return x, info
    bytes_per_frame = block_align if block_align else ch * (bits // 8)
    frames = n_data // bytes_per_frame if bytes_per_frame else 0
    info = WavInfo(sample_rate=sr, channels=ch, frames=frames, bits=bits,
                   format_tag=tag, loops=loops)
    if info_only:
        return None, info

    raw = np.frombuffer(audio, np.uint8)[: frames * bytes_per_frame]
    x = decode_pcm_samples(raw, tag, bits)
    x = x.reshape(frames, ch).T.copy()  # planar [channels, frames]
    return x, info


def decode_pcm_samples(raw: np.ndarray, tag: int, bits: int) -> np.ndarray:
    """Interleaved raw PCM/float bytes -> flat float32 samples (shared by
    the full decoder and the chunked reader, io/chunked.py)."""
    raw = np.asarray(raw, np.uint8)
    if tag == WAVE_FORMAT_IEEE_FLOAT:
        dtype = np.float32 if bits == 32 else np.float64
        return raw.view(dtype).astype(np.float32)
    if tag == WAVE_FORMAT_PCM:
        if bits == 8:
            return (raw.astype(np.float32) - 128.0) / 128.0
        if bits == 16:
            return raw.view("<i2").astype(np.float32) / 32768.0
        if bits == 24:
            b = raw.reshape(-1, 3)
            vals = (
                b[:, 0].astype(np.uint32)
                | (b[:, 1].astype(np.uint32) << 8)
                | (b[:, 2].astype(np.uint32) << 16)
            ).astype(np.int32)
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            return vals.astype(np.float32) / float(1 << 23)
        if bits == 32:
            return raw.view("<i4").astype(np.float32) / float(1 << 31)
        raise ValueError(f"unsupported PCM bit depth {bits}")
    raise ValueError(f"unsupported WAVE format tag 0x{tag:04x}")


def encode_wav_samples(audio: np.ndarray, bits: int, float_format: bool) -> bytes:
    """Encode planar float32 [channels, frames] into interleaved WAV sample
    bytes for the given format."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    inter = np.ascontiguousarray(audio.T)  # [frames, channels]
    if float_format:
        if bits != 32:
            raise ValueError("float WAV must be 32-bit")
        return inter.astype("<f4").tobytes()
    if bits == 16:
        clipped = np.clip(inter, -1.0, 1.0)
        return (clipped * 32767.0).round().astype("<i2").tobytes()
    if bits == 24:
        clipped = np.clip(inter, -1.0, 1.0)
        v = (clipped * float((1 << 23) - 1)).round().astype(np.int32)
        b = np.empty((v.size, 3), np.uint8)
        flat = v.reshape(-1)
        b[:, 0] = flat & 0xFF
        b[:, 1] = (flat >> 8) & 0xFF
        b[:, 2] = (flat >> 16) & 0xFF
        return b.tobytes()
    if bits == 32:
        clipped = np.clip(inter, -1.0, 1.0)
        return (clipped * float((1 << 31) - 1)).round().astype("<i4").tobytes()
    raise ValueError(f"unsupported PCM bit depth {bits}")


def wav_header(sample_rate: int, channels: int, bits: int, float_format: bool,
               data_bytes: int) -> bytes:
    """RIFF/WAVE header up to and including the data chunk header."""
    tag = WAVE_FORMAT_IEEE_FLOAT if float_format else WAVE_FORMAT_PCM
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    fmt = struct.pack("<HHIIHH", tag, channels, sample_rate, byte_rate,
                      block_align, bits)
    body_len = 4 + 8 + len(fmt) + 8 + data_bytes + (data_bytes & 1)
    return (b"RIFF" + struct.pack("<I", body_len) + b"WAVE"
            + b"fmt " + struct.pack("<I", len(fmt)) + fmt
            + b"data" + struct.pack("<I", data_bytes))


def write_wav(path, audio: np.ndarray, sample_rate: int, bits: int = 32, float_format: bool = True):
    """Write planar float32 [channels, frames] (or [frames] mono).

    Default: 32-bit float, matching the reference's offline render output
    (src/output/wav.rs:97-105)."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    payload = encode_wav_samples(audio, bits, float_format)
    with open(path, "wb") as f:
        f.write(wav_header(sample_rate, audio.shape[0], bits, float_format,
                           len(payload)))
        f.write(payload)
        if len(payload) & 1:
            f.write(b"\x00")
