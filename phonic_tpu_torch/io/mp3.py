"""MP3 decode via the system's libmpg123 (ctypes, no pip dependency).

Behavioural spec: reference src/source/file/decoder.rs — phonic itself does
not implement MPEG audio; it delegates to the symphonia crate
(Cargo.toml:46-56).  This module delegates to the host's mpg123 decoder
library: a ctypes binding with no Python package dependency.
When no libmpg123 is present the loader raises UnsupportedFormatError so
callers can hook `register_decoder` instead.

Output: planar float32 [channels, frames] at the stream rate (decoded with
mpg123's float output so no int16 round-trip loss is added).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
from pathlib import Path

import numpy as np

from ..errors import MediaFileError, UnsupportedFormatError

MPG123_OK = 0
MPG123_DONE = -12
MPG123_NEW_FORMAT = -11
MPG123_NEED_MORE = -10
MPG123_ENC_FLOAT_32 = 0x200

_lib = None
_lib_err = None


def _candidate_names():
    yield "libmpg123.so.0"
    yield "libmpg123.so"
    found = ctypes.util.find_library("mpg123")
    if found:
        yield found
    # pygame and other manylinux wheels bundle a renamed copy
    for pat in (os.path.join(os.path.dirname(np.__file__), "..",
                             "pygame.libs", "libmpg123*.so*"),):
        for p in sorted(glob.glob(pat)):
            yield p


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    last = None
    for name in _candidate_names():
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            last = e
            continue
        try:
            _bind(lib)
        except AttributeError as e:
            last = e
            continue
        # mpg123 < 1.27 requires global init (a no-op afterwards)
        if hasattr(lib, "mpg123_init"):
            lib.mpg123_init()
        _lib = lib
        return lib
    _lib_err = last or OSError("no libmpg123 candidates")
    return None


def _bind(lib):
    lib.mpg123_new.restype = ctypes.c_void_p
    lib.mpg123_new.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_delete.argtypes = [ctypes.c_void_p]
    lib.mpg123_open.restype = ctypes.c_int
    lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.mpg123_close.argtypes = [ctypes.c_void_p]
    lib.mpg123_getformat.restype = ctypes.c_int
    lib.mpg123_getformat.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.mpg123_format_none.argtypes = [ctypes.c_void_p]
    lib.mpg123_format.restype = ctypes.c_int
    lib.mpg123_format.argtypes = [ctypes.c_void_p, ctypes.c_long,
                                  ctypes.c_int, ctypes.c_int]
    lib.mpg123_read.restype = ctypes.c_int
    lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_rates.argtypes = [ctypes.POINTER(ctypes.POINTER(ctypes.c_long)),
                                 ctypes.POINTER(ctypes.c_size_t)]
    lib.mpg123_strerror.restype = ctypes.c_char_p
    lib.mpg123_strerror.argtypes = [ctypes.c_void_p]


def mp3_available() -> bool:
    return _load() is not None


def read_mp3(path) -> tuple[np.ndarray, int]:
    """Decode an MPEG audio file to (float32 [channels, frames], rate)."""
    lib = _load()
    if lib is None:
        raise UnsupportedFormatError(
            f"{path}: no libmpg123 found on this host ({_lib_err}); install "
            "mpg123 or register a decoder with register_decoder('mp3', fn)")
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise MediaFileError(f"mpg123_new failed (code {err.value})")
    try:
        # force float32 output for EVERY supported rate BEFORE open, so not
        # a single chunk decodes in the default int16 format
        lib.mpg123_format_none(h)
        rates = ctypes.POINTER(ctypes.c_long)()
        n_rates = ctypes.c_size_t(0)
        lib.mpg123_rates(ctypes.byref(rates), ctypes.byref(n_rates))
        for i in range(n_rates.value):
            lib.mpg123_format(h, rates[i], 3,  # MONO|STEREO
                              MPG123_ENC_FLOAT_32)
        if lib.mpg123_open(h, str(path).encode()) != MPG123_OK:
            raise MediaFileError(
                f"cannot open {path}: {lib.mpg123_strerror(h).decode()}")
        rate = ctypes.c_long(0)
        channels = ctypes.c_int(0)
        encoding = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(channels),
                                ctypes.byref(encoding)) != MPG123_OK:
            raise MediaFileError(
                f"{path}: {lib.mpg123_strerror(h).decode()}")
        if encoding.value != MPG123_ENC_FLOAT_32:
            raise MediaFileError(
                f"{path}: mpg123 refused float32 output "
                f"(encoding {encoding.value:#x})")

        chunks = []
        buf = (ctypes.c_byte * (1 << 18))()
        done = ctypes.c_size_t(0)
        while True:
            rc = lib.mpg123_read(h, buf, len(buf), ctypes.byref(done))
            if done.value:
                chunks.append(np.frombuffer(
                    bytes(bytearray(buf)[: done.value]), np.float32))
            if rc == MPG123_DONE:
                break
            if rc in (MPG123_OK, MPG123_NEW_FORMAT, MPG123_NEED_MORE):
                if rc == MPG123_NEED_MORE and not done.value:
                    break  # truncated stream: keep what decoded
                continue
            raise MediaFileError(
                f"{path}: mpg123 error {rc}: {lib.mpg123_strerror(h).decode()}")
        if not chunks:
            raise MediaFileError(f"{path}: no audio frames decoded")
        inter = np.concatenate(chunks)
        ch = max(channels.value, 1)
        frames = len(inter) // ch
        planar = inter[: frames * ch].reshape(frames, ch).T.copy()
        return planar, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)
