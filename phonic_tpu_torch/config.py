"""Engine-wide configuration (PyTorch port of ``phonic_tpu/config.py``).

The engine renders in large fixed-size blocks stepped from the host; per-
sample control is lowered to analytic parameter ramps, so block size only
trades latency against throughput, not correctness.

The device defaults to the CUDA card: ``EngineConfig()`` renders on the GPU
and raises if there is none.  Nothing silently drops to the CPU; a CPU
render asks for it with ``EngineConfig(device="cpu")``.
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

# Reference sample rate that smoother coefficients are normalised against
# (reference: src/utils/smoothing.rs:150 `sample_rate_comp = 44100 / sr`).
SMOOTHER_REFERENCE_SR = 44100.0

# Default smoothing inertia for exponential parameter smoothing
# (reference: src/utils/smoothing.rs:135 `DEFAULT_INERTIA = 1/256`).
DEFAULT_INERTIA = 1.0 / 256.0

# Snap threshold: the reference stops ramping once the per-sample increment
# drops below 100 * f32 epsilon (reference: src/utils/smoothing.rs:196-200).
SMOOTHER_EPSILON = 100.0 * float(torch.finfo(torch.float32).eps)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a usable card
    raises instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but torch.cuda.is_available() "
            "is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {str(device)!r}")
    return dev


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static configuration for one render program."""

    sample_rate: int = 48000
    channels: int = 2
    # Frames per render block.  Large blocks amortise per-block host work
    # and give the recurrence kernels long parallel runs.
    block_frames: int = 8192
    # Maximum number of scheduled parameter events honoured per block; events
    # beyond this are folded onto the final segment by the host lowering.
    max_events_per_block: int = 16
    # render homogeneous FileSources as one lane bank (graph/batching.py)
    batch_sources: bool = True
    # run sibling mixers' identical effect chains as one batched chain with
    # a leading lane dimension (see Effect.batch_key)
    batch_effects: bool = True
    # the step also returns every mixer's peak/RMS levels (the Player's
    # metering)
    meter_mixers: bool = False
    # skip (pass through, state kept) an effect whose input has been silent
    # for longer than its worst-case tail + 2 s (the Player's effects)
    auto_bypass: bool = False
    # dtype used for audio samples.
    dtype: torch.dtype = torch.float32
    # dtype used for recursive filter state / recurrences.  The CUDA kernels
    # take float32 only; float64 runs on the CPU plain versions.
    scan_dtype: torch.dtype = torch.float32
    device: Union[str, torch.device] = "cuda"


DEFAULT_CONFIG = EngineConfig()
