"""Low-frequency oscillator (port of ``lfo_block`` and ``sine_approx``
from ``phonic_tpu/ops/lfo.py``; the slice needs the sine waveform only,
the other six come with the modulation slice).

Behavioural spec: reference src/utils/dsp/lfo.rs.

The sine is a pure function of the accumulated phase, so a block is
evaluated at once: phase[i] = phase0 + exclusive cumsum(inc).  The fast
sine approximation matches the reference in formula
(src/utils/dsp/lfo.rs:7-19).  Rows run batched: state ``[G]``, increments
``[G, n]``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_PI = math.pi


def sine_approx(x: torch.Tensor) -> torch.Tensor:
    """Fast parabolic sine approximation for x in [-pi, pi]
    (reference: src/utils/dsp/lfo.rs:7-19)."""
    b = 4.0 / _PI
    c = -4.0 / (_PI * _PI)
    p = 0.225
    y = b * x + c * x * torch.abs(x)
    return p * (y * torch.abs(y) - y) + y


class LfoState(NamedTuple):
    phase: torch.Tensor  # float32 in [0, 1), [G]
    wraps: torch.Tensor  # int32 cumulative wrap count, [G]


def lfo_init(phase: float = 0.0, device="cpu") -> LfoState:
    """One oscillator's state (the engine stacks lanes along a new dim)."""
    return LfoState(torch.tensor(phase, dtype=torch.float32, device=device),
                    torch.tensor(0, dtype=torch.int32, device=device))


def lfo_block(state: LfoState, phase_inc: torch.Tensor, n: int):
    """Render n samples of the sine LFO per row.  ``phase_inc`` =
    rate/sample_rate, ``[G, n]``.  The value at sample i uses the phase
    *before* the i-th advance (reference run() order,
    src/utils/dsp/lfo.rs:122-170)."""
    inc = phase_inc.to(torch.float32).expand(state.phase.shape[0], n)
    # the running phase sums up to 131072 increments: a float32 scan's
    # rounding depends on its association order (a CUDA scan drifted by
    # 4e-6 from the exact sum at that length, the CPU's by 2e-7), so the
    # sum runs in float64 and is rounded once
    csum = torch.cumsum(inc.to(torch.float64), dim=-1).to(torch.float32)
    raw_phase = state.phase[:, None] + torch.cat(
        [torch.zeros_like(csum[:, :1]), csum[:, :-1]], dim=-1)
    phase = raw_phase - torch.floor(raw_phase)
    tau = 2.0 * _PI
    out = sine_approx(torch.where(phase < 0.5, phase * tau, (phase - 1.0) * tau))
    end_raw = state.phase + csum[:, -1]
    new_state = LfoState(
        phase=end_raw - torch.floor(end_raw),
        wraps=state.wraps + torch.floor(end_raw).to(torch.int32))
    return new_state, out
