"""Volume fader for de-clicked starts/stops (port of
``phonic_tpu/ops/fader.py``).

Behavioural spec: reference src/utils/fader.rs — an exponential per-frame
ramp toward a target volume with inertia chosen so the fade reaches 99 % of
the target in the configured duration:

    inertia = 1 - exp(-ln(100) / (sr * duration))
    v += (target - v) * inertia        (once per frame)

state: 0 = stopped (bypass, gain 1), 1 = running, 2 = finished (gain ==
target).  The reference flips running->finished when |v - target| < 1e-4,
checked once per processed block (src/utils/fader.rs:118-121); as in the
JAX package the check applies per frame analytically, which bounds the
output difference by 1e-4 (-80 dB) on already-faded material and removes
the reference's block-size dependence.  Plain tensor operations; the state
fields are 0-d tensors (or share a leading batch).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

STOPPED = 0
RUNNING = 1
FINISHED = 2

_LN100 = math.log(100.0)
_DONE_EPS = 1e-4


class FaderState(NamedTuple):
    mode: torch.Tensor  # int32
    current: torch.Tensor  # f32
    target: torch.Tensor  # f32
    inertia: torch.Tensor  # f32


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def fader_init(device="cpu") -> FaderState:
    one = _f32(1.0, device)
    return FaderState(torch.tensor(STOPPED, dtype=torch.int32, device=device),
                      one, one.clone(), one.clone())


def fader_inertia(duration_secs, sample_rate: int) -> torch.Tensor:
    d = _f32(duration_secs)
    samples = float(sample_rate) * d / _LN100
    return torch.where(d > 0.0,
                       1.0 - torch.exp(-1.0 / torch.clamp(samples, min=1e-9)),
                       1.0)


def fader_start(state: FaderState, from_v, to_v, duration_secs,
                sample_rate: int) -> FaderState:
    """start(from, to, duration) (reference: src/utils/fader.rs:76-93).
    Zero duration jumps straight to finished."""
    dev = state.current.device
    d = _f32(duration_secs, dev)
    return FaderState(
        mode=torch.where(d > 0.0, RUNNING, FINISHED).to(torch.int32),
        current=_f32(from_v, dev),
        target=_f32(to_v, dev),
        inertia=fader_inertia(d, sample_rate).to(dev),
    )


def fader_block(state: FaderState, n: int):
    """Per-frame gains for one block.  Returns (new_state, gains [..., n])."""
    cur, tgt = state.current[..., None], state.target[..., None]
    mode = state.mode[..., None]
    j = torch.arange(1, n + 1, dtype=torch.float32, device=cur.device)
    decay = torch.exp(torch.log1p(-torch.clamp(state.inertia, max=1.0 - 1e-9)
                                  )[..., None] * j)
    ramp = tgt + (cur - tgt) * decay
    done = torch.abs(ramp - tgt) < _DONE_EPS
    running = mode == RUNNING
    gains = torch.where(running, torch.where(done, tgt, ramp),
                        torch.where(mode == FINISHED, tgt, 1.0))
    run0, done_end = running[..., 0], done[..., -1]
    end_cur = torch.where(run0 & ~done_end, ramp[..., -1], state.target)
    new_mode = torch.where(run0 & done_end, FINISHED, state.mode).to(torch.int32)
    return FaderState(new_mode, end_cur, state.target, state.inertia), gains
