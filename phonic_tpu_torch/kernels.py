"""Build and load the hand-written CUDA kernels in ``csrc/``.

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc`` process per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes``.  The library lands in ``_build/<hash>/`` inside the package,
keyed by a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one is reused.  Nothing is built or loaded at import time: the
CPU-only test environment imports every module but never calls
:func:`library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libphonic_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    "phonic_ramp_read": ([_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "phonic_iir1": ([_I] + [_P] * 5 + [_L, _I, _L, ctypes.c_uint, _P], _I),
    "phonic_iir2": ([_I] + [_P] * 11 + [_L, _I, _L, ctypes.c_uint, _P], _I),
    "phonic_iir1_scratch": ([_I, _L], _L),
    "phonic_iir2_scratch": ([_I, _L], _L),
    "phonic_follower": ([_I] + [_P] * 6 + [_I, _L, _P], _I),
    "phonic_gate": ([_I] + [_P] * 9 + [_I, _L, _P], _I),
    "phonic_cuda_error_string": ([_I], ctypes.c_char_p),
}


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Path of the built library, compiling it first if needed.  The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside it as ``build.log``."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out = BUILD_DIR / digest.hexdigest()[:16] / LIB_NAME
    if out.is_file():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    objs, procs = [], []
    for src in (s for s in _sources() if s.suffix == ".cu"):
        obj = out.with_name(f"{src.stem}.{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate()[0] for p in procs]
    tmp = out.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(link.stdout + link.stderr)
        failed = [link.returncode] if link.returncode != 0 else []
    (out.parent / "build.log").write_text("".join(logs))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed with code {failed[0]}:\n"
                           f"{''.join(logs)[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library with every function's C signature set."""
    lib = ctypes.CDLL(str(library_path()))
    for name, (args, res) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = res
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = library().phonic_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """Raw handle of the current CUDA stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, what: str, *, ndim: int, dtype=torch.float32,
            device=None) -> None:
    """Validate a kernel operand: CUDA, dtype, rank, contiguity, device."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if device is not None and t.device != device:
        raise ValueError(f"{what}: on {t.device}, expected {device}")
