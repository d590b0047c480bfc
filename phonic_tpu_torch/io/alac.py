"""ALAC (Apple Lossless) decode — MP4/m4a container + ALAC bitstream — and a
fixture-grade encoder, in Python/NumPy; each packet decodes in the native
decoder (csrc/flacdec.cpp, see ``decode_packet``).

Behavioural spec: the reference decodes ALAC through the `alac` crate
(reference Cargo.toml:46-56; src/source/file/decoder.rs probes formats and
fully decodes).  This implements the codec per Apple's published ALAC
sources (github.com/macosforge/alac: ALACDecoder.cpp / ag_dec.cpp /
dp_dec.cpp, APSL-licensed spec-by-code): SCE/CPE elements, adaptive
Golomb/Rice ("ag") entropy coding with history + zero-run escapes, the
adaptive-LPC predictor with coefficient adaptation, order-31 first-order
mode, prediction type 15's double pass, stereo decorrelation (shift +
left weight), extra-bits (shifted) samples, and verbatim escape frames.

The encoder half mirrors the decoder's adaptive state exactly (like
io/flac.py's fixture encoder) so the test-suite can round-trip every
decoder path without binary fixtures; it emits minimal but spec-conformant
m4a files (ftyp/moov with full sample tables/mdat).
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from ..errors import MediaFileError, UnsupportedFormatError


# ---------------------------------------------------------------------------
# bit I/O (MSB first, like the FLAC module's but kept local: ALAC needs
# show-without-consume semantics)
# ---------------------------------------------------------------------------

class _BitReader:
    def __init__(self, data):
        self.d = data
        self.pos = 0

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        end = self.pos + n
        b0, b1 = self.pos >> 3, (end + 7) >> 3
        if b1 > len(self.d):
            raise MediaFileError("truncated ALAC stream")
        chunk = int.from_bytes(self.d[b0:b1], "big")
        shift = (b1 << 3) - end
        self.pos = end
        return (chunk >> shift) & ((1 << n) - 1)

    def sbits(self, n: int) -> int:
        v = self.bits(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def show(self, n: int) -> int:
        save = self.pos
        try:
            v = self.bits(n)
        finally:
            self.pos = save
        return v

    def skip(self, n: int):
        self.pos += n

    def align(self):
        self.pos = (self.pos + 7) & ~7


class _BitWriter:
    def __init__(self):
        self.buf = bytearray()
        self.acc = 0
        self.n = 0

    def bits(self, value: int, n: int):
        if n == 0:
            return
        self.acc = (self.acc << n) | (value & ((1 << n) - 1))
        self.n += n
        while self.n >= 8:
            self.n -= 8
            self.buf.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def align(self):
        if self.n:
            self.bits(0, 8 - self.n)

    def bytes(self) -> bytes:
        assert self.n == 0
        return bytes(self.buf)


def _sign_extend(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v & (1 << (bits - 1)) else v


def _log2(v: int) -> int:
    return v.bit_length() - 1 if v > 0 else 0


# ---------------------------------------------------------------------------
# adaptive Golomb ("ag") entropy coding — Apple ag_dec.cpp dyn_decomp
# ---------------------------------------------------------------------------

def _decode_scalar(br: _BitReader, k: int, bps: int) -> int:
    # unary prefix, at most 9 ones; 9 ones (no terminator) escapes to raw
    x = 0
    while x <= 8 and br.bits(1):
        x += 1
    if x > 8:
        return br.bits(bps)
    if k != 1:
        extra = br.show(k)
        x = (x << k) - x  # x * (2^k - 1)
        if extra > 1:
            x += extra - 1
            br.skip(k)
        else:
            br.skip(k - 1)
    return x


def _encode_scalar(bw: _BitWriter, val: int, k: int, bps: int):
    m = (1 << k) - 1
    q = val // m if k != 1 else val
    if q > 8:
        bw.bits((1 << 9) - 1, 9)  # nine 1s: escape, no terminator
        bw.bits(val, bps)
        return
    bw.bits(((1 << q) - 1) << 1, q + 1)  # q ones + terminating 0
    if k != 1:
        r = val - q * m
        if r == 0:
            bw.bits(0, k - 1)
        else:
            bw.bits(r + 1, k)


def _rice_decompress(br: _BitReader, n: int, bps: int, mult: int,
                     mb: int, kb: int) -> np.ndarray:
    out = np.zeros(n, np.int64)
    history = mb
    sign_modifier = 0
    i = 0
    while i < n:
        k = min(_log2((history >> 9) + 3), kb)
        x = _decode_scalar(br, k, bps) + sign_modifier
        sign_modifier = 0
        out[i] = (x >> 1) ^ -(x & 1)
        if x > 0xFFFF:
            history = 0xFFFF
        else:
            history += x * mult - ((history * mult) >> 9)
        if history < 128 and i + 1 < n:
            k = min(7 - _log2(history) + ((history + 16) >> 6), kb)
            run = _decode_scalar(br, k, 16)
            if run > 0:
                if run > n - i - 1:
                    raise MediaFileError("ALAC zero run overruns frame")
                out[i + 1:i + 1 + run] = 0
                i += run
            if run <= 0xFFFF:
                sign_modifier = 1
            history = 0
        i += 1
    return out


def _rice_compress(bw: _BitWriter, vals: np.ndarray, bps: int, mult: int,
                   mb: int, kb: int):
    """Exact mirror of _rice_decompress (state transitions identical)."""
    n = len(vals)
    history = mb
    sign_modifier = 0
    i = 0
    while i < n:
        k = min(_log2((history >> 9) + 3), kb)
        v = int(vals[i])
        x = ((v << 1) ^ (v >> 63)) & 0xFFFFFFFF  # zigzag (v is int64)
        _encode_scalar(bw, x - sign_modifier, k, bps)
        sign_modifier = 0
        if x > 0xFFFF:
            history = 0xFFFF
        else:
            history += x * mult - ((history * mult) >> 9)
        if history < 128 and i + 1 < n:
            k = min(7 - _log2(history) + ((history + 16) >> 6), kb)
            run = 0
            while run < n - i - 1 and run < 0xFFFF and vals[i + 1 + run] == 0:
                run += 1
            # a zero run reaching the frame end minus nothing is fine; the
            # decoder forbids run > n-i-1 which the loop bound enforces
            _encode_scalar(bw, run, k, 16)
            i += run
            if run <= 0xFFFF:
                sign_modifier = 1
            history = 0
        i += 1


# ---------------------------------------------------------------------------
# predictors — Apple dp_dec.cpp unpc_block
# ---------------------------------------------------------------------------

def _lpc_prediction(err: np.ndarray, bps: int, coefs: list, order: int,
                    quant: int) -> np.ndarray:
    n = len(err)
    out = np.zeros(n, np.int64)
    out[0] = err[0]
    if order == 0:
        out[:] = err
        return out
    if order == 31:  # pure first-order mode
        for i in range(1, n):
            out[i] = _sign_extend(int(out[i - 1] + err[i]), bps)
        return out
    for i in range(1, min(order + 1, n)):
        out[i] = _sign_extend(int(out[i - 1] + err[i]), bps)
    coefs = list(coefs)
    for i in range(order + 1, n):
        d = int(out[i - order - 1])
        val = 0
        for j in range(order):
            val += (int(out[i - order + j]) - d) * coefs[j]
        val = (val + (1 << (quant - 1))) >> quant
        error_val = int(err[i])
        out[i] = _sign_extend(val + d + error_val, bps)
        # coefficient adaptation driven by the residual sign
        if error_val > 0:
            for j in range(order):
                if error_val <= 0:
                    break
                val = d - int(out[i - order + j])
                sign = (val > 0) - (val < 0)
                coefs[j] -= sign
                val *= sign
                error_val -= (val >> quant) * (j + 1)
        elif error_val < 0:
            for j in range(order):
                if error_val >= 0:
                    break
                val = d - int(out[i - order + j])
                sign = (val > 0) - (val < 0)
                coefs[j] += sign
                val *= sign
                error_val -= (-(val) >> quant) * (j + 1)
    return out


def _lpc_residual(x: np.ndarray, bps: int, coefs: list, order: int,
                  quant: int) -> np.ndarray:
    """Encoder mirror: residuals such that _lpc_prediction reconstructs x
    exactly (replays the same coefficient adaptation)."""
    n = len(x)
    err = np.zeros(n, np.int64)
    err[0] = x[0]
    if order == 0:
        err[:] = x
        return err
    if order == 31:
        for i in range(1, n):
            err[i] = int(x[i]) - int(x[i - 1])
        return err
    for i in range(1, min(order + 1, n)):
        err[i] = int(x[i]) - int(x[i - 1])
    coefs = list(coefs)
    for i in range(order + 1, n):
        d = int(x[i - order - 1])
        val = 0
        for j in range(order):
            val += (int(x[i - order + j]) - d) * coefs[j]
        val = (val + (1 << (quant - 1))) >> quant
        # decoder reconstructs sign_extend(val + d + err, bps): any residual
        # congruent mod 2^bps works, so take the minimal representative —
        # it always fits the bps-bit escape width
        error_val = _sign_extend(int(x[i]) - (val + d), bps)
        err[i] = error_val
        if error_val > 0:
            for j in range(order):
                if error_val <= 0:
                    break
                val = d - int(x[i - order + j])
                sign = (val > 0) - (val < 0)
                coefs[j] -= sign
                val *= sign
                error_val -= (val >> quant) * (j + 1)
        elif error_val < 0:
            for j in range(order):
                if error_val >= 0:
                    break
                val = d - int(x[i - order + j])
                sign = (val > 0) - (val < 0)
                coefs[j] += sign
                val *= sign
                error_val -= (-(val) >> quant) * (j + 1)
    return err


# ---------------------------------------------------------------------------
# element / packet decode — Apple ALACDecoder.cpp Decode()
# ---------------------------------------------------------------------------

ID_SCE, ID_CPE, ID_CCE, ID_LFE, ID_DSE, ID_PCE, ID_FIL, ID_END = range(8)


class AlacCookie:
    def __init__(self, raw: bytes):
        if len(raw) < 24:
            raise MediaFileError("ALAC magic cookie too short")
        (self.frame_length, self.compatible_version, self.bit_depth,
         self.pb, self.mb, self.kb, self.num_channels, self.max_run,
         self.max_frame_bytes, self.avg_bit_rate, self.sample_rate) = \
            struct.unpack(">IBBBBBBHIII", raw[:24])

    def pack(self) -> bytes:
        return struct.pack(
            ">IBBBBBBHIII", self.frame_length, self.compatible_version,
            self.bit_depth, self.pb, self.mb, self.kb, self.num_channels,
            self.max_run, self.max_frame_bytes, self.avg_bit_rate,
            self.sample_rate)


def decode_packet(cookie: AlacCookie, packet: bytes) -> np.ndarray:
    """One ALAC packet -> int32 [channels, samples], decoded by the native
    decoder (csrc/flacdec.cpp ph_alac_packet, ~100x the Python loop); the
    Python loop below is the readable spec the tests hold it against."""
    if cookie.num_channels > 8:
        raise UnsupportedFormatError(
            f"ALAC with {cookie.num_channels} channels (at most 8)")
    from .flac import _native_lib
    return _decode_packet_native(_native_lib(), cookie, packet)


def _decode_packet_native(lib, cookie: AlacCookie, packet: bytes) -> np.ndarray:
    import ctypes
    stride = max(int(cookie.frame_length), 1)
    out = np.empty((cookie.num_channels, stride), np.int32)
    got_ch = ctypes.c_uint32(0)
    rc = lib.ph_alac_packet(
        packet, len(packet),
        cookie.frame_length, cookie.bit_depth, cookie.pb, cookie.mb,
        cookie.kb,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), stride,
        cookie.num_channels, ctypes.byref(got_ch))
    if rc == -2:
        raise UnsupportedFormatError("ALAC element unsupported")
    if rc < 0:
        raise MediaFileError("native ALAC packet decode failed")
    return out[:got_ch.value, :rc].copy()


def _decode_packet_py(cookie: AlacCookie, packet: bytes) -> np.ndarray:
    br = _BitReader(packet)
    chans: list[np.ndarray] = []
    nb_samples = cookie.frame_length
    while True:
        tag = br.bits(3)
        if tag == ID_END:
            break
        if tag in (ID_FIL, ID_DSE):
            raise UnsupportedFormatError(f"ALAC element {tag} unsupported")
        if tag not in (ID_SCE, ID_CPE, ID_LFE):
            raise MediaFileError(f"bad ALAC element tag {tag}")
        channels = 2 if tag == ID_CPE else 1
        br.bits(4)  # element instance tag
        if br.bits(12) != 0:
            raise MediaFileError("ALAC: non-zero unused header bits")
        has_size = br.bits(1)
        extra_bits = br.bits(2) << 3
        is_verbatim = br.bits(1)
        out_samples = br.bits(32) if has_size else cookie.frame_length
        bps = cookie.bit_depth - extra_bits + channels - 1
        if not is_verbatim:
            decorr_shift = br.bits(8)
            decorr_left_weight = br.bits(8)
            pred_type, quant, hist_mult, order, coefs = [], [], [], [], []
            for _ch in range(channels):
                pred_type.append(br.bits(4))
                quant.append(br.bits(4))
                hist_mult.append(br.bits(3))
                o = br.bits(5)
                order.append(o)
                c = [0] * o
                for i in range(o - 1, -1, -1):  # stream stores them reversed
                    c[i] = br.sbits(16)
                coefs.append(c)
            extra = None
            if extra_bits:
                extra = np.zeros((channels, out_samples), np.int64)
                for i in range(out_samples):
                    for ch in range(channels):
                        extra[ch, i] = br.bits(extra_bits)
            bufs = []
            for ch in range(channels):
                err = _rice_decompress(
                    br, out_samples, bps,
                    (hist_mult[ch] * cookie.pb) // 4, cookie.mb, cookie.kb)
                if pred_type[ch] == 15:
                    # double prediction: an order-31 pass feeds the LPC pass
                    err = _lpc_prediction(err, bps, [], 31, 0)
                bufs.append(_lpc_prediction(err, bps, coefs[ch],
                                            order[ch], quant[ch]))
            x = np.stack(bufs)
            if channels == 2 and decorr_left_weight:
                a = x[0] - ((x[1] * decorr_left_weight) >> decorr_shift)
                b = x[1] + a
                x = np.stack([b, a])
            if extra_bits:
                x = (x << extra_bits) | extra
        else:
            x = np.zeros((channels, out_samples), np.int64)
            for i in range(out_samples):
                for ch in range(channels):
                    x[ch, i] = br.sbits(cookie.bit_depth)
        chans.extend(x)
        nb_samples = out_samples
    for c in chans:
        if len(c) != nb_samples:
            raise MediaFileError("ALAC element sample-count mismatch")
    return np.stack(chans).astype(np.int32) if chans else \
        np.zeros((cookie.num_channels, 0), np.int32)


# ---------------------------------------------------------------------------
# MP4 (m4a) container
# ---------------------------------------------------------------------------

def _boxes(data, start, end):
    pos = start
    while pos + 8 <= end:
        size, = struct.unpack_from(">I", data, pos)
        btype = bytes(data[pos + 4:pos + 8])
        body = pos + 8
        if size == 1:
            size, = struct.unpack_from(">Q", data, pos + 8)
            body = pos + 16
        elif size == 0:
            size = end - pos
        if size < 8 or pos + size > end:
            break
        yield btype, body, pos + size
        pos += size


def _find_box(data, start, end, *path):
    for btype, body, bend in _boxes(data, start, end):
        if btype == path[0]:
            if len(path) == 1:
                return body, bend
            return _find_box(data, body, bend, *path[1:])
    return None


def parse_m4a(data):
    """Returns (cookie, packets: list[bytes]).  Raises if no alac track."""
    cookie, index = parse_m4a_index(data)
    return cookie, [bytes(data[off:off + size]) for off, size in index]


def parse_m4a_index(data):
    """Returns (cookie, index: list[(byte_offset, byte_size)]) for the ALAC
    track's packets — the random-access form of parse_m4a (MP4 sample
    tables; each ALAC packet decodes independently, so any packet can be
    fetched and decoded without its predecessors)."""
    moov = _find_box(data, 0, len(data), b"moov")
    if moov is None:
        raise MediaFileError("m4a: missing moov box")
    for btype, tbody, tend in _boxes(data, *moov):
        if btype != b"trak":
            continue
        stbl = _find_box(data, tbody, tend, b"mdia", b"minf", b"stbl")
        if stbl is None:
            continue
        stsd = _find_box(data, *stbl, b"stsd")
        if stsd is None:
            continue
        body, bend = stsd
        count, = struct.unpack_from(">I", data, body + 4)
        pos = body + 8
        cookie = None
        for _ in range(count):
            esize, = struct.unpack_from(">I", data, pos)
            fmt = bytes(data[pos + 4:pos + 8])
            if fmt == b"alac":
                # SoundSampleEntry: 8 (size+format) + 6 reserved + 2 dref +
                # 8 version/revision/vendor + 2 ch + 2 bits + 2 + 2 + 4 rate
                sub = pos + 36
                found = _find_box(data, sub, pos + esize, b"alac")
                if found is not None:
                    cbody, cend = found
                    cookie = AlacCookie(bytes(data[cbody + 4:cend]))
            pos += esize
        if cookie is None:
            continue
        stsz = _find_box(data, *stbl, b"stsz")
        stsc = _find_box(data, *stbl, b"stsc")
        stco = _find_box(data, *stbl, b"stco")
        co64 = _find_box(data, *stbl, b"co64")
        if stsz is None or stsc is None or (stco is None and co64 is None):
            raise MediaFileError("m4a: incomplete sample tables")
        b, _ = stsz
        fixed, scount = struct.unpack_from(">II", data, b + 4)
        sizes = ([fixed] * scount if fixed else
                 list(struct.unpack_from(f">{scount}I", data, b + 12)))
        b, _ = stsc
        ecount, = struct.unpack_from(">I", data, b + 4)
        stsc_rows = [struct.unpack_from(">III", data, b + 8 + 12 * i)
                     for i in range(ecount)]
        if stco is not None:
            b, _ = stco
            ccount, = struct.unpack_from(">I", data, b + 4)
            offsets = list(struct.unpack_from(f">{ccount}I", data, b + 8))
        else:
            b, _ = co64
            ccount, = struct.unpack_from(">I", data, b + 4)
            offsets = list(struct.unpack_from(f">{ccount}Q", data, b + 8))
        # expand stsc: samples per chunk
        index = []
        si = 0
        for ci in range(ccount):
            spc = 0
            for fi, (first, per, _idx) in enumerate(stsc_rows):
                if ci + 1 >= first:
                    spc = per
            off = offsets[ci]
            for _ in range(spc):
                if si >= scount:
                    break
                index.append((off, sizes[si]))
                off += sizes[si]
                si += 1
        return cookie, index
    raise UnsupportedFormatError("m4a: no ALAC audio track")


def read_alac(path):
    """Decode an m4a/ALAC file -> (float32 [channels, frames], sample_rate)."""
    data = Path(path).read_bytes()
    cookie, packets = parse_m4a(data)
    if not packets:
        raise MediaFileError(f"{path}: no ALAC packets")
    chunks = [decode_packet(cookie, p) for p in packets]
    audio = np.concatenate(chunks, axis=1)
    scale = np.float32(1.0 / (1 << (cookie.bit_depth - 1)))
    return audio.astype(np.float32) * scale, int(cookie.sample_rate)


# ---------------------------------------------------------------------------
# fixture-grade encoder (decoder-state mirror, like io/flac.py's)
# ---------------------------------------------------------------------------

def _encode_packet(cookie: AlacCookie, x: np.ndarray, mode: str,
                   order: int = 0, quant: int = 9) -> bytes:
    bw = _BitWriter()
    channels = x.shape[0]
    n = x.shape[1]
    pos = 0
    while pos < channels:
        ec = 2 if channels - pos >= 2 else 1
        tag = ID_CPE if ec == 2 else ID_SCE
        seg = x[pos:pos + ec]
        bw.bits(tag, 3)
        bw.bits(0, 4)
        bw.bits(0, 12)
        partial = n != cookie.frame_length
        bw.bits(1 if partial else 0, 1)
        bw.bits(0, 2)  # no extra bits
        if mode == "verbatim":
            bw.bits(1, 1)
            if partial:
                bw.bits(n, 32)
            for i in range(n):
                for ch in range(ec):
                    bw.bits(int(seg[ch, i]), cookie.bit_depth)
        else:
            bw.bits(0, 1)
            if partial:
                bw.bits(n, 32)
            bw.bits(0, 8)  # decorr shift
            bw.bits(0, 8)  # decorr left weight (0 = independent channels)
            bps = cookie.bit_depth + ec - 1
            hist_mult = 4  # -> mult = pb
            o = 31 if mode == "order31" else order
            q = 0 if o in (0, 31) else quant
            # the wire always carries `order` coefficient slots — order 31
            # streams include 31 (ignored) coefficients too, matching the
            # decoder's unconditional read
            coefs = [(1 << q) >> 1 or 1] * (o if o not in (0, 31) else 0)
            wire_coefs = coefs if o != 31 else [0] * 31
            for _ch in range(ec):
                bw.bits(0, 4)   # prediction type 0
                bw.bits(q or 9, 4)  # quant (must be nonzero on the wire)
                bw.bits(hist_mult, 3)
                bw.bits(o, 5)
                for i in range(len(wire_coefs) - 1, -1, -1):  # reversed
                    bw.bits(wire_coefs[i] & 0xFFFF, 16)
            for ch in range(ec):
                qq = q if o not in (0, 31) else 0
                err = _lpc_residual(seg[ch].astype(np.int64), bps,
                                    list(coefs), o, qq)
                _rice_compress(bw, err, bps, (hist_mult * cookie.pb) // 4,
                               cookie.mb, cookie.kb)
        pos += ec
    bw.bits(ID_END, 3)
    bw.align()
    return bw.bytes()


def _full_box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def write_alac(path, audio: np.ndarray, sample_rate: int,
               mode: str = "rice", order: int = 0,
               frame_length: int = 4096):
    """Encode planar float32 [ch, frames] (|x|<=1) to a minimal m4a/ALAC.
    mode: 'verbatim' | 'rice' (order 0) | 'order31'; order>0 with
    mode='rice' exercises the adaptive-LPC path."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    ch, frames = audio.shape
    ints = np.clip(np.round(audio * 32767.0), -32768, 32767).astype(np.int64)
    cookie = AlacCookie(struct.pack(
        ">IBBBBBBHIII", frame_length, 0, 16, 40, 10, 14, ch, 255,
        0, 0, sample_rate))
    packets = []
    for start in range(0, frames, frame_length):
        seg = ints[:, start:start + frame_length]
        packets.append(_encode_packet(cookie, seg, mode, order))
    mdat_payload = b"".join(packets)

    # ---- boxes -----------------------------------------------------------
    ftyp = _full_box(b"ftyp", b"M4A \x00\x00\x00\x00M4A mp42isom")
    # cookie box inside the alac sample entry
    alac_cookie_box = _full_box(b"alac", b"\x00\x00\x00\x00" + cookie.pack())
    sample_entry = (struct.pack(">I4s", 36 + len(alac_cookie_box), b"alac")
                    + b"\x00" * 6 + struct.pack(">H", 1)
                    + b"\x00" * 8
                    + struct.pack(">HHHH", ch, 16, 0, 0)
                    + struct.pack(">I", sample_rate << 16)
                    + alac_cookie_box)
    stsd = _full_box(b"stsd", struct.pack(">II", 0, 1) + sample_entry)
    npk = len(packets)
    rem = frames % frame_length
    entries = []
    if npk > 1 or not rem:
        entries.append((npk - 1 if rem else npk, frame_length))
    if rem:
        entries.append((1, rem))
    entries = [(c, d) for c, d in entries if c > 0]
    stts = _full_box(b"stts", struct.pack(">II", 0, len(entries))
                     + b"".join(struct.pack(">II", c, d) for c, d in entries))
    stsc = _full_box(b"stsc", struct.pack(">I", 0) + struct.pack(">I", 1)
                     + struct.pack(">III", 1, npk, 1))
    stsz = _full_box(b"stsz", struct.pack(">III", 0, 0, npk)
                     + b"".join(struct.pack(">I", len(p)) for p in packets))
    # mdat follows moov; compute its chunk offset after sizing moov
    stbl_wo_stco = stsd + stts + stsc + stsz
    # one chunk holding all packets
    def build(offset):
        stco = _full_box(b"stco", struct.pack(">II", 0, 1)
                         + struct.pack(">I", offset))
        stbl = _full_box(b"stbl", stbl_wo_stco + stco)
        dinf = _full_box(b"dinf", _full_box(
            b"dref", struct.pack(">II", 0, 1)
            + _full_box(b"url ", b"\x00\x00\x00\x01")))
        smhd = _full_box(b"smhd", b"\x00" * 8)
        minf = _full_box(b"minf", smhd + dinf + stbl)
        mdhd = _full_box(b"mdhd", struct.pack(
            ">IIIII", 0, 0, 0, sample_rate, frames) + struct.pack(">HH", 0x55C4, 0))
        hdlr = _full_box(b"hdlr", b"\x00" * 8 + b"soun" + b"\x00" * 12 + b"\x00")
        mdia = _full_box(b"mdia", mdhd + hdlr + minf)
        tkhd = _full_box(b"tkhd", struct.pack(
            ">IIIII", 7, 0, 0, 1, 0) + b"\x00" * 60)
        trak = _full_box(b"trak", tkhd + mdia)
        mvhd = _full_box(b"mvhd", struct.pack(
            ">IIIII", 0, 0, 0, sample_rate, frames) + b"\x00" * 80)
        return _full_box(b"moov", mvhd + trak)

    moov = build(0)
    offset = len(ftyp) + len(moov) + 8
    moov = build(offset)
    mdat = _full_box(b"mdat", mdat_payload)
    Path(path).write_bytes(ftyp + moov + mdat)
