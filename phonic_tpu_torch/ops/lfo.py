"""Low-frequency oscillator bank (port of ``phonic_tpu/ops/lfo.py``).

Behavioural spec: reference src/utils/dsp/lfo.rs.

All 7 waveforms (sine / triangle / ramp up / ramp down / square / random
S&H / smooth random) are pure functions of the accumulated phase, so a
block is evaluated at once: phase[i] = phase0 + exclusive cumsum(inc).  The
fast sine approximation matches the reference in formula
(src/utils/dsp/lfo.rs:7-19).  The random waveforms draw a counter-based
hash of (seed, wrap index), as the JAX package defines them.  Rows run
batched: state ``[G]``, increments ``[G, n]``, waveform id per row.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import consts

# waveform ids are indices into this tuple
SINE = 0
TRIANGLE = 1
RAMP_UP = 2
RAMP_DOWN = 3
SQUARE = 4
RANDOM = 5
SMOOTH_RANDOM = 6

WAVEFORM_NAMES = (
    "Sine", "Triangle", "Ramp Up", "Ramp Down", "Square", "Random", "Smooth Random",
)

_PI = math.pi
_M32 = 0xFFFFFFFF


def sine_approx(x: torch.Tensor) -> torch.Tensor:
    """Fast parabolic sine approximation for x in [-pi, pi]
    (reference: src/utils/dsp/lfo.rs:7-19)."""
    b = 4.0 / _PI
    c = -4.0 / (_PI * _PI)
    p = 0.225
    y = b * x + c * x * torch.abs(x)
    return p * (y * torch.abs(y) - y) + y


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) and a 32-bit constant c,
    in two 16-bit halves of c so that no int64 product overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _hash_random(seed, k) -> torch.Tensor:
    """Deterministic uniform [-1, 1) float32 value for integer counter k: the
    JAX package's uint32 splitmix-style hash, emulated in int64 (PyTorch's
    uint32 has few operations) with every product and shift kept mod 2**32.
    ``seed`` is an int or an integer tensor that broadcasts against ``k``
    (one seed per voice)."""
    x = torch.as_tensor(k).to(torch.int64) & _M32
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64) & _M32
    else:
        seed = int(seed) & _M32
    x = _mul32(x, 0x9E3779B9) ^ seed
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x.to(torch.float32) / float(2**32)) * 2.0 - 1.0


class LfoState(NamedTuple):
    phase: torch.Tensor  # float32 in [0, 1), [G]
    wraps: torch.Tensor  # int32 cumulative wrap count, [G]


def lfo_init(phase: float = 0.0, device="cpu") -> LfoState:
    """One oscillator's state (the engine stacks lanes along a new dim)."""
    return LfoState(torch.tensor(phase, dtype=torch.float32, device=device),
                    torch.tensor(0, dtype=torch.int32, device=device))


def lfo_block(state: LfoState, phase_inc: torch.Tensor, n: int,
              waveform=None, seed: int = 0):
    """Render n samples of the LFO per row.  ``phase_inc`` =
    rate/sample_rate, ``[G, n]``; ``waveform`` is the waveform id per row
    (``[G]``, clipped to 0..6), or None for the sine alone.  The value at
    sample i uses the phase *before* the i-th advance (reference run()
    order, src/utils/dsp/lfo.rs:122-170)."""
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
    sine = sine_approx(torch.where(phase < 0.5, phase * tau, (phase - 1.0) * tau))
    end_raw = state.phase + csum[:, -1]
    new_state = LfoState(
        phase=end_raw - torch.floor(end_raw),
        wraps=state.wraps + torch.floor(end_raw).to(torch.int32))
    if waveform is None:
        return new_state, sine

    wrap_idx = state.wraps[:, None] + torch.floor(raw_phase).to(torch.int32)
    triangle = torch.where(
        phase < 0.25, phase * 4.0,
        torch.where(phase < 0.75, 2.0 - phase * 4.0, phase * 4.0 - 4.0))
    ramp_up = phase * 2.0 - 1.0
    ramp_down = 1.0 - phase * 2.0
    square = torch.where(phase < 0.5, 1.0, -1.0)
    random = _hash_random(seed, wrap_idx)
    # smooth random: cosine-ish interpolation between consecutive wrap values
    # with the same sine approximation (src/utils/dsp/lfo.rs:151-156)
    t = (1.0 - sine_approx(_PI / 2.0 - phase * _PI)) * 0.5
    target = _hash_random(seed, wrap_idx.to(torch.int64) + 1)
    smooth = random + t * (target - random)
    stacked = torch.stack([sine, triangle, ramp_up, ramp_down, square, random,
                           smooth], dim=1)  # [G, 7, n]
    wf = torch.clamp(consts.as_device(waveform, torch.int64, phase.device)
                     .expand(phase.shape[0]), 0, 6)
    out = torch.gather(stacked, 1, wf[:, None, None].expand(-1, 1, n))[:, 0]
    return new_state, out
