"""Realtime output via the native ring-buffer bridge (ctypes); port of
``phonic_tpu/outputs/rt.py``.

The C++ side (csrc/ringbuf.cpp) owns the real-time constraints: a
lock-free SPSC ring fed by the Python render pump and drained by a
dedicated consumer thread into ALSA (when libasound is present) or a
wall-clock-paced sink.  Writing blocks when the ring is full, which paces
the pump exactly like a device callback would pace the reference's
audio thread (reference: src/output/cpal.rs).

The bridge builds with g++ at first use into the package's ``_build/``
directory, as the FLAC decoder does (io/flac.py).  ``rt_available()`` is
False when it cannot be built or loaded (``default_output_device``
chooses on it); ``RtOutput`` and ``convert_f32`` then raise
``OutputDeviceError``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path
from typing import Optional

import numpy as np

from ..errors import OutputDeviceError
from .base import OutputDevice

_PKG = Path(__file__).resolve().parent.parent
_RT_SRC = _PKG / "csrc" / "ringbuf.cpp"
_CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
_LIBS = ("-lpthread", "-ldl")
# why the bridge could not be built or loaded, once _load_lib has tried
_build_error = None


def _native_path() -> Path:
    """The built bridge library, compiling it with g++ first if needed
    (the path holds a hash of the source and flags; concurrent builds each
    write a temporary file and rename it into place).  Raises
    ``OutputDeviceError`` with the compiler's output when it cannot."""
    digest = hashlib.sha256(" ".join(_CXX_FLAGS + _LIBS).encode())
    digest.update(_RT_SRC.read_bytes())
    out = _PKG / "_build" / f"rt-{digest.hexdigest()[:16]}" / "libphonic_rt.so"
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        build = subprocess.run(["g++", *_CXX_FLAGS, "-o", str(tmp),
                                str(_RT_SRC), *_LIBS],
                               capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise OutputDeviceError(f"cannot run g++ to build {_RT_SRC.name}: "
                                f"{e}") from e
    if build.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise OutputDeviceError(f"g++ failed with code {build.returncode} "
                                f"building {_RT_SRC.name}:\n"
                                f"{(build.stdout + build.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


@lru_cache(maxsize=1)
def _load_lib():
    """ctypes handle to csrc/ringbuf.cpp, built on first use; None when it
    cannot be built or loaded (``_build_error`` says why)."""
    global _build_error
    try:
        lib = ctypes.CDLL(str(_native_path()))
    except (OutputDeviceError, OSError) as e:
        _build_error = str(e)
        return None
    lib.ph_ring_create.restype = ctypes.c_void_p
    lib.ph_ring_create.argtypes = [ctypes.c_uint32, ctypes.c_uint32,
                                   ctypes.c_uint32, ctypes.c_int]
    lib.ph_ring_write.restype = ctypes.c_int
    lib.ph_ring_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                  ctypes.c_uint32]
    lib.ph_ring_position.restype = ctypes.c_uint64
    lib.ph_ring_position.argtypes = [ctypes.c_void_p]
    lib.ph_ring_space.restype = ctypes.c_uint32
    lib.ph_ring_space.argtypes = [ctypes.c_void_p]
    lib.ph_ring_pause.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ph_ring_close.argtypes = [ctypes.c_void_p]
    lib.ph_ring_uses_alsa.restype = ctypes.c_int
    lib.ph_ring_uses_alsa.argtypes = [ctypes.c_void_p]
    lib.ph_alsa_available.restype = ctypes.c_int
    lib.ph_alsa_list_devices.restype = ctypes.c_int
    lib.ph_alsa_list_devices.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.ph_ring_create_dev.restype = ctypes.c_void_p
    lib.ph_ring_create_dev.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
        ctypes.c_char_p,
    ]
    lib.ph_ring_format.restype = ctypes.c_int
    lib.ph_ring_format.argtypes = [ctypes.c_void_p]
    lib.ph_convert_f32_to_s16.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16),
        ctypes.c_uint32]
    lib.ph_convert_f32_to_s32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_uint32]
    return lib


# ALSA snd_pcm_format_t values the bridge negotiates (FLOAT first, then the
# integer fallbacks real devices offer; reference dispatches i8..f64 with an
# f32 fast path, src/output/cpal.rs:509-561)
_FORMAT_NAMES = {14: "f32", 10: "i32", 2: "i16"}


def convert_f32(block: np.ndarray, fmt: str) -> np.ndarray:
    """Run the native sample-format conversion (consumer-thread code path)
    on host data — unit-testable without sound hardware.  ``fmt`` is one of
    "f32", "i32", "i16"."""
    lib = _require_lib()
    flat = np.ascontiguousarray(np.asarray(block, np.float32)).reshape(-1)
    src = flat.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if fmt == "f32":
        return flat.copy()
    if fmt == "i16":
        out = np.empty(flat.shape, np.int16)
        lib.ph_convert_f32_to_s16(
            src, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), flat.size)
        return out
    if fmt == "i32":
        out = np.empty(flat.shape, np.int32)
        lib.ph_convert_f32_to_s32(
            src, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), flat.size)
        return out
    raise OutputDeviceError(f"unknown sample format {fmt!r}")


def _require_lib():
    lib = _load_lib()
    if lib is None:
        raise OutputDeviceError(f"native realtime bridge unavailable: "
                                f"{_build_error}")
    return lib


def rt_available() -> bool:
    """Whether the bridge builds and loads."""
    return _load_lib() is not None


def list_alsa_devices() -> list[tuple[str, str]]:
    """Enumerate ALSA playback devices as (name, description) pairs
    (reference: cpal's device iteration behind DefaultOutputDevice).
    Empty when ALSA or the native bridge is unavailable."""
    lib = _load_lib()
    if lib is None:
        return []
    buf = ctypes.create_string_buffer(1 << 16)
    n = lib.ph_alsa_list_devices(buf, len(buf))
    if n <= 0:
        return []
    out = []
    for line in buf.value.decode("utf-8", "replace").splitlines():
        name, _, desc = line.partition("\t")
        if name:
            out.append((name, desc))
    return out


def alsa_available() -> bool:
    lib = _load_lib()
    return bool(lib and lib.ph_alsa_available())


@dataclass
class RtOutputConfig:
    """Device selection + negotiation knobs, mirroring the reference's
    CpalOutputConfig (src/output/cpal.rs:76-86): driver is implicit (ALSA is
    the one Linux backend the bridge speaks), device picks a PCM by name,
    sample_rate/buffer_size None = preferred defaults (44100 preferred like
    cpal.rs:32-34; the bridge defaults to 48000 to match EngineConfig)."""
    device: str = ""                       # "" = driver default PCM
    sample_rate: Optional[int] = None      # None = preferred (48000)
    channels: int = 2
    buffer_size: Optional[int] = None      # frames; None = 0.25 s
    try_alsa: bool = True


class RtOutput(OutputDevice):
    @classmethod
    def open_with_config(cls, config: RtOutputConfig) -> "RtOutput":
        """Open from a config struct (reference:
        CpalOutput::open_with_config, src/output/cpal.rs:110-117)."""
        sr = config.sample_rate or 48000
        buffer_secs = (config.buffer_size / sr if config.buffer_size
                       else 0.25)
        return cls(sample_rate=sr, channels=config.channels,
                   buffer_secs=buffer_secs, try_alsa=config.try_alsa,
                   device=config.device)

    def __init__(self, sample_rate: int = 48000, channels: int = 2,
                 buffer_secs: float = 0.25, try_alsa: bool = True,
                 device: str = ""):
        """``device`` picks an ALSA PCM by name (see list_alsa_devices);
        empty = "default"."""
        lib = _require_lib()
        self._lib = lib
        self._sr = sample_rate
        self._ch = channels
        self._handle = lib.ph_ring_create_dev(
            int(buffer_secs * sample_rate), sample_rate, channels,
            1 if try_alsa else 0, device.encode("utf-8"),
        )
        if not self._handle:
            raise OutputDeviceError("failed to create native audio ring")

    @property
    def sample_rate(self) -> int:
        return self._sr

    @property
    def channel_count(self) -> int:
        return self._ch

    @property
    def sample_position(self) -> int:
        return int(self._lib.ph_ring_position(self._handle))

    @property
    def uses_alsa(self) -> bool:
        return bool(self._lib.ph_ring_uses_alsa(self._handle))

    @property
    def sample_format(self) -> str:
        """Negotiated device sample format ("f32"/"i32"/"i16"): FLOAT_LE is
        tried first, then S32_LE, then S16_LE (src/output/cpal.rs:509-561's
        dispatch, narrowed to the formats real ALSA devices offer)."""
        return _FORMAT_NAMES.get(
            int(self._lib.ph_ring_format(self._handle)), "f32")

    def space_frames(self) -> int:
        return int(self._lib.ph_ring_space(self._handle))

    def write(self, block) -> None:
        block = self._apply_volume(block)
        # planar [ch, n] -> interleaved contiguous f32
        inter = np.ascontiguousarray(np.asarray(block, np.float32).T).reshape(-1)
        ptr = inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        self._lib.ph_ring_write(self._handle, ptr, inter.shape[0] // self._ch)

    def pause(self) -> None:
        self._paused = True
        self._lib.ph_ring_pause(self._handle, 1)

    def resume(self) -> None:
        self._paused = False
        self._lib.ph_ring_pause(self._handle, 0)

    def close(self) -> None:
        if self._handle:
            self._lib.ph_ring_close(self._handle)
            self._handle = None
