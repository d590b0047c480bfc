"""FLAC decoding (and a fixture-grade encoder) in pure Python/NumPy.

Behavioural spec: the reference decodes FLAC through symphonia
(reference Cargo.toml:46-56; src/source/file/decoder.rs probes formats and
fully decodes into the planar buffer).  This implements the FLAC bitstream
per the format spec (https://xiph.org/flac/format.html): STREAMINFO,
frame headers with UTF-8 coded numbers, constant / verbatim / fixed /
LPC subframes, 4- and 5-bit Rice partitions with escape codes, wasted
bits, and left/right/mid-side stereo decorrelation.

The per-frame hot loop runs in the native decoder (csrc/flacdec.cpp,
~100x the Python loop), built with g++ at first use into the package's
``_build/`` directory; a failed build or load raises with the compiler's
output.  The Python implementation below is the readable spec that the
tests hold the native decoder against; it is no fallback.

The encoder half exists so the test-suite can round-trip every decoder
path without shipping binary fixtures; it is deliberately minimal (16-bit,
one Rice partition order) but emits spec-conformant streams with correct
CRC-8/CRC-16.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..errors import MediaFileError

_PKG = Path(__file__).resolve().parent.parent
_IO_SRC = _PKG / "csrc" / "flacdec.cpp"
_CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")


def _native_path() -> Path:
    """The built decoder library, compiling it with g++ first if needed.
    The path holds a hash of the source and flags, so an edited source
    rebuilds; concurrent builds each write a temporary file and rename
    it into place."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS).encode())
    digest.update(_IO_SRC.read_bytes())
    out = _PKG / "_build" / f"io-{digest.hexdigest()[:16]}" / "libphonic_io.so"
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        build = subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp), str(_IO_SRC)],
                               capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run g++ to build {_IO_SRC.name}: {e}") from e
    if build.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {build.returncode} "
                           f"building {_IO_SRC.name}:\n"
                           f"{(build.stdout + build.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=1)
def _native_lib():
    """ctypes handle to csrc/flacdec.cpp, built on first use; raises if it
    cannot be built or loaded."""
    lib = ctypes.CDLL(str(_native_path()))
    lib.ph_flac_frame.restype = ctypes.c_int
    lib.ph_flac_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32,
    ]
    lib.ph_alac_packet.restype = ctypes.c_int
    lib.ph_alac_packet.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_uint32,
        ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint32),
    ]
    return lib


_MAX_FRAME = 65536


def _decode_frame_native(lib, br: "_BitReader", channels: int, bps: int):
    """Native per-frame decode sharing the Python reader's cursor."""
    view = getattr(br, "_np_view", None)
    if view is None:
        view = np.frombuffer(br.d, np.uint8)
        br._np_view = view
        br._scratch = np.empty((channels, _MAX_FRAME), np.int32)
    out = br._scratch
    off = ctypes.c_uint64(br.pos >> 3)
    rc = lib.ph_flac_frame(
        ctypes.c_void_p(view.ctypes.data), ctypes.c_uint64(view.shape[0]),
        ctypes.byref(off), channels, bps,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _MAX_FRAME)
    if rc < 0:
        raise MediaFileError("native FLAC frame decode failed")
    if rc == 0:
        br.pos = len(br.d) * 8  # clean EOF: park the cursor
        return None
    br.pos = off.value * 8
    return [out[c, :rc].astype(np.int64) for c in range(channels)]

_FIXED_COEFFS = {
    0: [],
    1: [1],
    2: [2, -1],
    3: [3, -3, 1],
    4: [4, -6, 4, -1],
}


class _BitReader:
    def __init__(self, data: bytes):
        self.d = data
        self.pos = 0  # bit index

    def bits(self, n: int) -> int:
        end = self.pos + n
        b0, b1 = self.pos >> 3, (end + 7) >> 3
        if b1 > len(self.d):
            raise MediaFileError("truncated FLAC stream")
        chunk = int.from_bytes(self.d[b0:b1], "big")
        shift = (b1 << 3) - end
        self.pos = end
        return (chunk >> shift) & ((1 << n) - 1)

    def sbits(self, n: int) -> int:
        v = self.bits(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def unary(self) -> int:
        count = 0
        d = self.d
        while True:
            idx = self.pos >> 3
            if idx >= len(d):
                raise MediaFileError("truncated FLAC stream")
            bit_in = self.pos & 7
            byte = d[idx] & (0xFF >> bit_in)
            if byte == 0:
                count += 8 - bit_in
                self.pos += 8 - bit_in
            else:
                zeros = (8 - bit_in) - byte.bit_length()
                self.pos += zeros + 1
                return count + zeros

    def align(self):
        self.pos = (self.pos + 7) & ~7

    def utf8_number(self) -> int:
        b0 = self.bits(8)
        if b0 < 0x80:
            return b0
        n = 0
        mask = 0x40
        while b0 & mask:
            n += 1
            mask >>= 1
        v = b0 & (mask - 1)
        for _ in range(n):
            v = (v << 6) | (self.bits(8) & 0x3F)
        return v

    def eof(self) -> bool:
        return (self.pos >> 3) >= len(self.d)


def _rice_read(br: _BitReader, param: int) -> int:
    q = br.unary()
    u = (q << param) | br.bits(param) if param else q
    return (u >> 1) ^ -(u & 1)  # un-zigzag


def _read_residual(br: _BitReader, blocksize: int, order: int) -> np.ndarray:
    method = br.bits(2)
    if method > 1:
        raise MediaFileError(f"reserved residual method {method}")
    pbits = 4 if method == 0 else 5
    escape = (1 << pbits) - 1
    porder = br.bits(4)
    nparts = 1 << porder
    part_len = blocksize >> porder
    if part_len == 0 or (part_len << porder) != blocksize:
        raise MediaFileError("invalid rice partition order")
    out = np.empty(blocksize - order, np.int64)
    w = 0
    for p in range(nparts):
        n = part_len - (order if p == 0 else 0)
        param = br.bits(pbits)
        if param == escape:
            raw = br.bits(5)
            for i in range(n):
                out[w + i] = br.sbits(raw) if raw else 0
        else:
            for i in range(n):
                out[w + i] = _rice_read(br, param)
        w += n
    return out


def _fixed_restore(order: int, warmup, res: np.ndarray) -> np.ndarray:
    if order == 0:
        return np.asarray(res, np.int64)
    w = np.asarray(warmup, np.int64)
    tails = []
    cur = w
    for _ in range(order):
        tails.append(int(cur[-1]))
        cur = np.diff(cur)
    arr = np.asarray(res, np.int64)
    for k in range(order - 1, -1, -1):
        arr = tails[k] + np.cumsum(arr)
    return np.concatenate([w, arr])


def _lpc_restore(order: int, warmup, coeffs, shift: int,
                 res: np.ndarray) -> np.ndarray:
    x = list(map(int, warmup))
    c = list(map(int, coeffs))
    for r in res.tolist():
        pred = 0
        for i in range(order):
            pred += c[i] * x[-1 - i]
        x.append((pred >> shift) + r)
    return np.asarray(x, np.int64)


def _read_subframe(br: _BitReader, blocksize: int, bps: int) -> np.ndarray:
    if br.bits(1):
        raise MediaFileError("invalid subframe padding bit")
    ftype = br.bits(6)
    wasted = 0
    if br.bits(1):
        wasted = br.unary() + 1
        bps -= wasted
    if ftype == 0:  # constant
        x = np.full(blocksize, br.sbits(bps), np.int64)
    elif ftype == 1:  # verbatim
        x = np.asarray([br.sbits(bps) for _ in range(blocksize)], np.int64)
    elif 8 <= ftype <= 12:  # fixed, order 0-4
        order = ftype - 8
        warmup = [br.sbits(bps) for _ in range(order)]
        res = _read_residual(br, blocksize, order)
        x = _fixed_restore(order, warmup, res) if order else res
    elif ftype >= 32:  # LPC, order 1-32
        order = (ftype & 0x1F) + 1
        warmup = [br.sbits(bps) for _ in range(order)]
        prec = br.bits(4) + 1
        if prec > 16:
            raise MediaFileError("invalid LPC precision")
        shift = br.sbits(5)
        coeffs = [br.sbits(prec) for _ in range(order)]
        res = _read_residual(br, blocksize, order)
        x = _lpc_restore(order, warmup, coeffs, shift, res)
    else:
        raise MediaFileError(f"reserved subframe type {ftype}")
    return x << wasted if wasted else x


_BLOCKSIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
               8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
               13: 8192, 14: 16384, 15: 32768}
_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000, 6: 22050,
          7: 24000, 8: 32000, 9: 44100, 10: 48000, 11: 96000}
_BPS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


def read_flac(path):
    """Decode a FLAC file -> (float32 [channels, frames], sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"fLaC":
        raise MediaFileError(f"{path}: not a FLAC file")
    pos = 4
    info = None
    while True:
        if pos + 4 > len(data):
            raise MediaFileError("missing STREAMINFO")
        hdr = int.from_bytes(data[pos : pos + 4], "big")
        last = hdr >> 31
        btype = (hdr >> 24) & 0x7F
        size = hdr & 0xFFFFFF
        if btype == 0:
            br = _BitReader(data[pos + 4 : pos + 4 + size])
            br.bits(16)  # min blocksize
            br.bits(16)  # max blocksize
            br.bits(24)
            br.bits(24)
            sr = br.bits(20)
            channels = br.bits(3) + 1
            bps = br.bits(5) + 1
            total = br.bits(36)
            info = (sr, channels, bps, total)
        pos += 4 + size
        if last:
            break
    if info is None:
        raise MediaFileError("missing STREAMINFO")
    sr, channels, bps, total = info

    br = _BitReader(data[pos:])
    chans: list[list[np.ndarray]] = [[] for _ in range(channels)]
    decoded = 0
    while (total == 0 or decoded < total) and not br.eof():
        subs = _decode_frame(br, channels, bps)
        if subs is None:  # clean end of stream (native path)
            break
        for ci in range(channels):
            chans[ci].append(subs[ci])
        decoded += subs[0].shape[0]

    audio = np.stack([np.concatenate(c) for c in chans])
    if total:
        audio = audio[:, :total]
    return (audio.astype(np.float32) / float(1 << (bps - 1))), sr


def _decode_frame(br: _BitReader, channels: int, bps: int):
    """Decode one FLAC frame at the reader's position; returns the per-
    channel int64 sample arrays (length = the frame's blocksize), or None
    on clean end-of-stream.  Runs csrc/flacdec.cpp (frames are
    byte-aligned, so the cursor round-trips exactly)."""
    return _decode_frame_native(_native_lib(), br, channels, bps)


def _decode_frame_py(br: _BitReader, channels: int, bps: int):
    sync = br.bits(14)
    if sync != 0x3FFE:
        raise MediaFileError(f"lost frame sync (0x{sync:04x})")
    br.bits(1)  # reserved
    br.bits(1)  # blocking strategy
    bs_code = br.bits(4)
    sr_code = br.bits(4)
    ch_code = br.bits(4)
    bps_code = br.bits(3)
    br.bits(1)  # reserved
    br.utf8_number()
    if bs_code == 6:
        blocksize = br.bits(8) + 1
    elif bs_code == 7:
        blocksize = br.bits(16) + 1
    elif bs_code in _BLOCKSIZES:
        blocksize = _BLOCKSIZES[bs_code]
    else:
        raise MediaFileError(f"reserved blocksize code {bs_code}")
    if sr_code == 12:
        br.bits(8)
    elif sr_code in (13, 14):
        br.bits(16)
    elif sr_code != 0 and sr_code not in _RATES:
        raise MediaFileError(f"invalid sample-rate code {sr_code}")
    fbps = _BPS.get(bps_code, bps)
    br.bits(8)  # header CRC-8 (not verified)

    if ch_code < 8:
        if ch_code + 1 != channels:
            raise MediaFileError("channel count mismatch")
        subs = [_read_subframe(br, blocksize, fbps)
                for _ in range(channels)]
    elif ch_code in (8, 9, 10):
        if channels != 2:
            raise MediaFileError("stereo decorrelation in non-stereo file")
        if ch_code == 8:  # left/side
            left = _read_subframe(br, blocksize, fbps)
            side = _read_subframe(br, blocksize, fbps + 1)
            subs = [left, left - side]
        elif ch_code == 9:  # right/side
            side = _read_subframe(br, blocksize, fbps + 1)
            right = _read_subframe(br, blocksize, fbps)
            subs = [right + side, right]
        else:  # mid/side
            mid = _read_subframe(br, blocksize, fbps)
            side = _read_subframe(br, blocksize, fbps + 1)
            l = ((mid << 1) | (side & 1)) + side
            subs = [l >> 1, (l - (side << 1)) >> 1]
    else:
        raise MediaFileError(f"reserved channel assignment {ch_code}")

    br.align()
    br.bits(16)  # frame CRC-16 (not verified)
    return subs


class FlacStream:
    """Sequential FLAC decode with bounded host memory: the file is mmapped
    (OS page cache, not process heap) and frames decode forward from a
    cursor; `restart()` rewinds for backward jumps (the chunked reader's
    LRU makes those rare).  Used by io/chunked.FlacChunkedReader."""

    def __init__(self, path):
        import mmap
        self._f = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):  # zero-length or exotic fs
            self._mm = self._f.read()
        data = self._mm
        if data[:4] != b"fLaC":
            raise MediaFileError(f"{path}: not a FLAC file")
        pos = 4
        info = None
        while True:
            if pos + 4 > len(data):
                raise MediaFileError("missing STREAMINFO")
            hdr = int.from_bytes(data[pos:pos + 4], "big")
            last = hdr >> 31
            btype = (hdr >> 24) & 0x7F
            size = hdr & 0xFFFFFF
            if btype == 0:
                br = _BitReader(data[pos + 4:pos + 4 + size])
                br.bits(16)
                br.bits(16)
                br.bits(24)
                br.bits(24)
                sr = br.bits(20)
                channels = br.bits(3) + 1
                bps = br.bits(5) + 1
                total = br.bits(36)
                info = (sr, channels, bps, total)
            pos += 4 + size
            if last:
                break
        if info is None:
            raise MediaFileError("missing STREAMINFO")
        self.sample_rate, self.channels, self._bps, self.total_frames = info
        self._audio_bit0 = pos * 8
        self.restart()
        if self.total_frames == 0:
            # STREAMINFO total=0 is legal ("unknown", e.g. streaming
            # encoders).  Everything downstream needs a concrete length
            # (durations, loop folds, static shapes), and FLAC frames have
            # no stored byte size, so one forward pass discovers it — and
            # warms the sparse seek index while it's at it.  Matches the
            # one-shot read_flac decoder's until-EOF semantics.
            self._discover_total()

    def _discover_total(self):
        while not self._br.eof():
            self._maybe_index()
            subs = _decode_frame(self._br, self.channels, self._bps)
            if subs is None:
                break
            self._decoded += np.asarray(subs[0]).shape[-1]
        self.total_frames = self._decoded
        self.restart()

    def _maybe_index(self):
        if (self._br.pos & 7) == 0 and self._decoded > 0 \
                and self._decoded // self._INDEX_EVERY > \
                    self._seek_index[-1][0] // self._INDEX_EVERY:
            self._seek_index.append((self._decoded, self._br.pos))

    def restart(self):
        self._br = _BitReader(self._mm)
        self._br.pos = self._audio_bit0
        self._decoded = 0  # stream frame index of the NEXT undecoded frame
        self._pending = None  # (start_frame, float32 [ch, blocksize])
        # sparse seek index discovered during forward decode:
        # (stream frame, bit cursor) every _INDEX_EVERY frames — backward
        # jumps rewind to the nearest indexed frame instead of byte 0
        # (the analog of symphonia's seek table, decoder.rs seek path)
        if not hasattr(self, "_seek_index"):
            self._seek_index = [(0, self._audio_bit0)]

    def seek_back(self, target: int):
        """Reposition the cursor at the best indexed frame <= target."""
        best = self._seek_index[0]
        for ent in self._seek_index:
            if ent[0] <= target and ent[0] >= best[0]:
                best = ent
        self._br = _BitReader(self._mm)
        self._br.pos = best[1]
        self._decoded = best[0]
        self._pending = None

    _INDEX_EVERY = 1 << 18  # ~5.5 s at 48 kHz between index points

    def position_of_pending(self) -> int:
        """Earliest stream position still readable without a restart."""
        return self._pending[0] if self._pending is not None else self._decoded

    def read_at(self, lo: int, n: int) -> np.ndarray:
        """Decode frames [lo, lo+n); requires lo >= position_of_pending()."""
        out = np.zeros((self.channels, n), np.float32)
        scale = np.float32(1.0 / (1 << (self._bps - 1)))

        def blit(fstart, arr):
            a = max(lo, fstart)
            b = min(lo + n, fstart + arr.shape[1])
            if b > a:
                out[:, a - lo:b - lo] = arr[:, a - fstart:b - fstart]

        if self._pending is not None:
            blit(*self._pending)
        while self._decoded < lo + n and self._decoded < self.total_frames \
                and not self._br.eof():
            self._maybe_index()
            subs = _decode_frame(self._br, self.channels, self._bps)
            if subs is None:  # clean end of stream (native path)
                break
            arr = (np.stack(subs).astype(np.float32) * scale)
            fstart = self._decoded
            self._decoded += arr.shape[1]
            self._pending = (fstart, arr)
            blit(fstart, arr)
        return out

    def close(self):
        self._br = None  # drop the native decoder's numpy view of the mmap
        self._pending = None
        if hasattr(self._mm, "close"):
            self._mm.close()
        self._f.close()


# ---------------------------------------------------------------------------
# fixture-grade encoder
# ---------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.nbits = 0

    def bits(self, value: int, n: int):
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.buf.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def unary(self, q: int):
        while q >= 32:
            self.bits(0, 32)
            q -= 32
        self.bits(1, q + 1)

    def align(self):
        if self.nbits:
            self.bits(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.buf)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


def _rice_write(bw: _BitWriter, values, param: int):
    for v in values:
        v = int(v)
        u = (-v << 1) - 1 if v < 0 else v << 1  # zigzag
        bw.unary(u >> param)
        if param:
            bw.bits(u & ((1 << param) - 1), param)


def _best_rice_param(values) -> int:
    a = np.abs(np.asarray(values, np.int64))
    mean = float(a.mean()) if len(a) else 0.0
    p = 0
    while (1 << (p + 1)) < mean + 1 and p < 14:
        p += 1
    return p


def _write_residual(bw: _BitWriter, res):
    bw.bits(0, 2)  # 4-bit rice
    bw.bits(0, 4)  # partition order 0
    param = _best_rice_param(res)
    bw.bits(param, 4)
    _rice_write(bw, res, param)


def _write_subframe(bw: _BitWriter, x: np.ndarray, bps: int, kind: str):
    x = np.asarray(x, np.int64)
    bw.bits(0, 1)
    if kind == "constant":
        bw.bits(0, 6)
        bw.bits(0, 1)
        bw.bits(int(x[0]), bps)
    elif kind == "verbatim":
        bw.bits(1, 6)
        bw.bits(0, 1)
        for v in x:
            bw.bits(int(v), bps)
    elif kind == "fixed2":
        order = min(2, len(x) - 1) if len(x) > 2 else 0
        bw.bits(8 + order, 6)
        bw.bits(0, 1)
        for v in x[:order]:
            bw.bits(int(v), bps)
        coef = _FIXED_COEFFS[order]
        res = [int(x[n]) - sum(c * int(x[n - 1 - i]) for i, c in enumerate(coef))
               for n in range(order, len(x))]
        _write_residual(bw, res)
    elif kind == "lpc2":
        order = 2
        bw.bits(32 + order - 1, 6)
        bw.bits(0, 1)
        for v in x[:order]:
            bw.bits(int(v), bps)
        prec, shift, coeffs = 4, 0, [2, -1]
        bw.bits(prec - 1, 4)
        bw.bits(shift, 5)
        for c in coeffs:
            bw.bits(c, prec)
        res = [int(x[n]) - ((coeffs[0] * int(x[n - 1])
                             + coeffs[1] * int(x[n - 2])) >> shift)
               for n in range(order, len(x))]
        _write_residual(bw, res)
    else:
        raise ValueError(f"unknown subframe kind {kind!r}")


def write_flac(path, audio: np.ndarray, sample_rate: int,
               subframe: str = "fixed2", stereo: str = "independent",
               blocksize: int = 4096):
    """Encode int16-range planar float32 (or int) audio as 16-bit FLAC.
    Test-grade: one Rice partition, fixed 4096 blocks.  ``subframe`` picks
    the coding path (constant/verbatim/fixed2/lpc2); ``stereo`` picks the
    decorrelation (independent/left_side/right_side/mid_side)."""
    a = np.asarray(audio)
    if a.ndim == 1:
        a = a[None, :]
    if a.dtype.kind == "f":
        a = np.clip(np.round(a * 32768.0), -32768, 32767)
    x = a.astype(np.int64)
    ch, frames = x.shape
    bps = 16

    out = bytearray(b"fLaC")
    si = _BitWriter()
    si.bits(blocksize, 16)
    si.bits(blocksize, 16)
    si.bits(0, 24)
    si.bits(0, 24)
    si.bits(sample_rate, 20)
    si.bits(ch - 1, 3)
    si.bits(bps - 1, 5)
    si.bits(frames, 36)
    for _ in range(16):
        si.bits(0, 8)
    body = si.bytes()
    out += (0x80000000 | (0 << 24) | len(body)).to_bytes(4, "big") + body

    frame_idx = 0
    for start in range(0, frames, blocksize):
        blk = x[:, start : start + blocksize]
        n = blk.shape[1]
        bw = _BitWriter()
        bw.bits(0x3FFE, 14)
        bw.bits(0, 1)
        bw.bits(0, 1)  # fixed blocksize strategy
        bw.bits(7, 4)  # 16-bit blocksize at end of header
        bw.bits(0, 4)  # sample rate from STREAMINFO
        if ch == 2 and stereo != "independent":
            code = {"left_side": 8, "right_side": 9, "mid_side": 10}[stereo]
            bw.bits(code, 4)
        else:
            bw.bits(ch - 1, 4)
        bw.bits(4, 3)  # 16 bps
        bw.bits(0, 1)
        assert frame_idx < 128
        bw.bits(frame_idx, 8)  # single-byte UTF-8 number
        bw.bits(n - 1, 16)
        hdr = bw  # crc8 over the bytes so far
        bw.bits(_crc8(bytes(hdr.buf)), 8)

        def put(sig, bits_, kd=subframe):
            kd = "constant" if np.all(sig == sig[0]) and kd == "constant" \
                else (kd if kd != "constant" else "verbatim")
            _write_subframe(bw, sig, bits_, kd)

        if ch == 2 and stereo == "left_side":
            put(blk[0], bps)
            put(blk[0] - blk[1], bps + 1)
        elif ch == 2 and stereo == "right_side":
            put(blk[0] - blk[1], bps + 1)
            put(blk[1], bps)
        elif ch == 2 and stereo == "mid_side":
            put((blk[0] + blk[1]) >> 1, bps)
            put(blk[0] - blk[1], bps + 1)
        else:
            for ci in range(ch):
                put(blk[ci], bps)
        bw.align()
        bw.bits(_crc16(bytes(bw.buf)), 16)
        out += bw.bytes()
        frame_idx += 1

    Path(path).write_bytes(bytes(out))


def _decode_flac_file(path):
    return read_flac(path)
