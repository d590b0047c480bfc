"""Oscillator building blocks for synth definitions (port of
``phonic_tpu/ops/osc.py``).

The reference builds synth voices from FunDSP graph nodes
(src/source/synth/fundsp.rs, src/utils/fundsp/multi_osc.rs); here the
equivalents are pure phase-domain functions over tensors with leading batch
dimensions (``[B, n]``: a bank of voices): a carried phase accumulates
per-sample frequency, waveshapes are evaluated analytically, and polyBLEP
corrections suppress aliasing on the discontinuous shapes.

Phases sum in float64 and round once to float32 (the JAX package sums in
float32), so the card and the CPU give the same phases whatever their order
of summation; against the JAX package they agree exactly where the
increments are dyadic.  An increment ``freq / sr`` is the product with the
rate's float32 reciprocal (ops/precision.recip32), as XLA compiles the
division, so at a power-of-two rate every increment is exact.
"""

from __future__ import annotations

import math

import torch

from .precision import recip32

_TWO_PI = 2.0 * math.pi


def phase_accumulate(phase0, freq: torch.Tensor, sr: int):
    """Phases in [0, 1) along the last axis from a carried phase and
    per-sample Hz.  ``freq`` [..., n]; ``phase0`` broadcasts against
    ``freq[..., 0]``.  Returns (phase [..., n], end phase [...])."""
    inc = _dt(freq, sr).to(torch.float64)
    p0 = torch.as_tensor(phase0, device=freq.device).to(torch.float64)
    csum = torch.cumsum(inc, dim=-1)
    raw = p0[..., None] + (csum - inc)  # exclusive sum
    end = p0 + csum[..., -1]
    return _wrap(raw), _wrap(end)


def _wrap(x64: torch.Tensor) -> torch.Tensor:
    """float64 phase -> its fractional part in float32, in [0, 1)."""
    frac = (x64 - torch.floor(x64)).to(torch.float32)
    return torch.where(frac >= 1.0, frac - 1.0, frac)


def _polyblep(t, dt):
    """2-sample polyBLEP residual at a discontinuity."""
    dt = torch.clamp(dt, min=1e-9)
    a = t / dt
    b = (t - 1.0) / dt + 1.0
    up = 2.0 * a - a * a - 1.0  # t < dt
    down = b * b + 2.0 * b + 1.0  # t > 1 - dt
    return torch.where(t < dt, up, torch.where(t > 1.0 - dt, down, 0.0))


def _dt(freq, sr: int):
    """``freq / sr`` as the JAX package's compiled step evaluates it: the
    product with the rate's float32 reciprocal."""
    return torch.as_tensor(freq, dtype=torch.float32) * recip32(sr)


def sine(phase):
    return torch.sin(_TWO_PI * phase)


def saw(phase, freq=None, sr: int = 48000):
    """Rising saw in [-1, 1]; pass freq for polyBLEP anti-aliasing."""
    naive = 2.0 * phase - 1.0
    if freq is None:
        return naive
    return naive - _polyblep(phase, _dt(freq, sr))


def square(phase, freq=None, sr: int = 48000, duty=0.5):
    naive = torch.where(phase < duty, 1.0, -1.0)
    if freq is None:
        return naive
    dt = _dt(freq, sr)
    t2 = torch.remainder(phase - duty, 1.0)
    return naive + _polyblep(phase, dt) - _polyblep(t2, dt)


def triangle(phase):
    return torch.where(phase < 0.25, phase * 4.0,
                       torch.where(phase < 0.75, 2.0 - phase * 4.0,
                                   phase * 4.0 - 4.0))


def morph_osc(phase, shape, freq=None, sr: int = 48000):
    """Morphing oscillator (reference: src/utils/fundsp/multi_osc.rs) —
    shape 0..3 crossfades sine -> triangle -> saw -> square.  ``shape`` is a
    number or a tensor that broadcasts against ``phase`` (a per-sample,
    runtime-automated morph); each sample's two neighbour waves are picked
    with ``torch.gather``."""
    shape = torch.clamp(torch.as_tensor(shape, dtype=torch.float32,
                                        device=phase.device), 0.0, 3.0)
    waves = torch.stack([sine(phase), triangle(phase), saw(phase, freq, sr),
                         square(phase, freq, sr)])
    lo = torch.clamp(shape.to(torch.int32), 0, 2)
    frac = shape - lo
    lo_b = lo.to(torch.int64).expand(waves.shape[1:])[None]
    wlo = torch.gather(waves, 0, lo_b)[0]
    whi = torch.gather(waves, 0, lo_b + 1)[0]
    return wlo * (1.0 - frac) + whi * frac
