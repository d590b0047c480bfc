"""Constant tensors made once per device.

``torch.tensor(host_value, device="cuda")`` copies from pageable host
memory, and such a copy waits for the stream: called inside a block step it
stalls the host until the card has finished everything queued before it.
Coefficient tables and scalars that every block needs are made here once
per (value, dtype, device) and shared; callers never write to them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64,
          torch.int32: np.int32, torch.int64: np.int64, torch.bool: np.bool_}


# a graph needs a few dozen constants per device; the bound only stops a
# caller that makes new values per block from growing the cache for ever
@functools.lru_cache(maxsize=4096)
def _make(data: bytes, shape: tuple, dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    arr = np.frombuffer(data, _NUMPY[dtype]).reshape(shape)
    return torch.tensor(arr, dtype=dtype, device=device)


def const(value, dtype: torch.dtype = torch.float32,
          device="cpu") -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``, made once and
    cached: the value is rounded to ``dtype`` on the host, as
    ``torch.tensor`` rounds it."""
    arr = np.ascontiguousarray(np.asarray(value, dtype=_NUMPY[dtype]))
    return _make(arr.tobytes(), arr.shape, dtype, torch.device(device))


def as_device(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)`` without a copy
    from the host per call: a tensor is cast (a no-op when it already is
    ``dtype``), a host value becomes a cached constant."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return const(x, dtype, device)
