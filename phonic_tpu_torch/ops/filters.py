"""Second-order TPT (topology-preserving transform) filters + DC blocker
(port of ``phonic_tpu/ops/filters.py``).

Behavioural spec:
  - biquad (9 types, Cytomic SVF topology): reference
    src/utils/dsp/filters/biquad.rs:160-290 (coefficients), :320-340 (core)
  - SVF (LP/HP/BP with resonance): reference src/utils/dsp/filters/svf.rs
  - DC blocker one-pole: reference src/utils/dsp/filters/dc.rs

Both filter families share the trapezoidal-integrator core

    v3 = x - ic2 ; v1 = a1*ic1 + a2*v3 ; v2 = ic2 + a2*ic1 + a3*v3
    ic1' = 2*v1 - ic1 ; ic2' = 2*v2 - ic2 ; y = m0*x + m1*v1 + m2*v2

which is linear in the state (ic1, ic2):

    A = [[2*a1-1, -2*a2], [2*a2, 1-2*a3]],  b = (2*a2*x, 2*a3*x)

so a whole block is one second-order recurrence
(ops/scan.linear_recurrence_2), per-sample coefficients included.
v1/v2 are recovered from consecutive states: v = (s[n] + s[n-1]) / 2.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import consts
from .scan import linear_recurrence, linear_recurrence_2

LOWPASS = "lowpass"
HIGHPASS = "highpass"
BANDPASS = "bandpass"
NOTCH = "notch"
PEAK = "peak"
ALLPASS = "allpass"
BELL = "bell"
LOWSHELF = "lowshelf"
HIGHSHELF = "highshelf"

BIQUAD_TYPES = (
    LOWPASS, HIGHPASS, BANDPASS, NOTCH, PEAK, ALLPASS, BELL, LOWSHELF, HIGHSHELF,
)
SVF_TYPES = (LOWPASS, HIGHPASS, BANDPASS)


class TptCoefficients(NamedTuple):
    """a1..a3 integrator gains + m0..m2 output mix (broadcastable against
    the signal; per-sample tensors for ramped parameters)."""

    a1: torch.Tensor
    a2: torch.Tensor
    a3: torch.Tensor
    m0: torch.Tensor
    m1: torch.Tensor
    m2: torch.Tensor


def per_channel(coefs: TptCoefficients) -> TptCoefficients:
    """Per-lane coefficients [G, n] -> [G, 1, n], broadcasting over the
    channels of a [G, ch, n] signal."""
    return TptCoefficients(*(c.unsqueeze(-2) if c.dim() > 0 else c
                             for c in coefs))


class TptState(NamedTuple):
    ic1: torch.Tensor
    ic2: torch.Tensor


def tpt_state_init(shape=(), dtype=torch.float32, device="cpu") -> TptState:
    return TptState(torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))


def biquad_coefficients(filter_type: str, sample_rate, cutoff, q,
                        gain_db=0.0) -> TptCoefficients:
    """Coefficients for the 9 biquad filter types
    (reference: src/utils/dsp/filters/biquad.rs:160-290).  ``cutoff`` is a
    float32 tensor; ``q`` and ``gain_db`` tensors or Python floats."""
    g = torch.tan(math.pi * cutoff / float(sample_rate))
    one = torch.ones_like(g)
    q = consts.as_device(q, torch.float32, g.device)
    if filter_type in (BELL, LOWSHELF, HIGHSHELF):
        a = torch.pow(10.0, consts.as_device(gain_db, torch.float32,
                                             g.device) / 40.0)
    k = 1.0 / (q * a) if filter_type == BELL else 1.0 / q
    if filter_type == LOWSHELF:
        g = g / torch.sqrt(a)
    elif filter_type == HIGHSHELF:
        g = g * torch.sqrt(a)

    a1 = 1.0 / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2

    if filter_type == LOWPASS:
        m0, m1, m2 = 0.0 * one, 0.0 * one, one
    elif filter_type == HIGHPASS:
        m0, m1, m2 = one, -k, -one
    elif filter_type == BANDPASS:
        m0, m1, m2 = 0.0 * one, one, 0.0 * one
    elif filter_type == NOTCH:
        m0, m1, m2 = one, -k, 0.0 * one
    elif filter_type == PEAK:
        m0, m1, m2 = one, -k, -2.0 * one
    elif filter_type == ALLPASS:
        m0, m1, m2 = one, -2.0 * k, 0.0 * one
    elif filter_type == BELL:
        m0, m1, m2 = one, k * (a * a - 1.0), 0.0 * one
    elif filter_type == LOWSHELF:
        m0, m1, m2 = one, k * (a - 1.0), a * a - 1.0
    elif filter_type == HIGHSHELF:
        m0, m1, m2 = a * a, k * (1.0 - a) * a, 1.0 - a * a
    else:
        raise ValueError(f"unknown biquad type {filter_type!r}")
    return TptCoefficients(a1, a2, a3, m0, m1, m2)


def svf_coefficients(filter_type: str, sample_rate, cutoff,
                     resonance) -> TptCoefficients:
    """SVF with 0..1 resonance mapped to damping k = max(2*(1-0.97*res), 0.03)
    (reference: src/utils/dsp/filters/svf.rs:170-186)."""
    g = torch.tan(math.pi * cutoff / float(sample_rate))
    k = torch.clamp(2.0 * (1.0 - resonance * 0.97), min=0.03)
    a1 = 1.0 / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2
    one = torch.ones_like(g)
    if filter_type == LOWPASS:
        m0, m1, m2 = 0.0 * one, 0.0 * one, one
    elif filter_type == BANDPASS:
        m0, m1, m2 = 0.0 * one, one, 0.0 * one
    elif filter_type == HIGHPASS:
        m0, m1, m2 = one, -k, -one
    else:
        raise ValueError(f"unknown svf type {filter_type!r}")
    return TptCoefficients(a1, a2, a3, m0, m1, m2)


def _prev_seq(s: torch.Tensor, s0: torch.Tensor) -> torch.Tensor:
    """s shifted one sample later along the last axis, s0 entering first."""
    return torch.cat([s0[..., None].expand(s[..., :1].shape), s[..., :-1]],
                     dim=-1)


def tpt_process(state: TptState, x: torch.Tensor, coefs: TptCoefficients,
                dtype=torch.float32):
    """Run the TPT core over a block.  ``x`` is ``[..., n]`` with samples
    last; coefficient fields broadcast against x (scalars or per-sample
    tensors); the state is shaped like ``x[..., 0]``.  Returns
    ``(new_state, y)``."""
    in_dtype = x.dtype
    xs = x.to(dtype)
    a1, a2, a3, m0, m1, m2 = (
        (c if isinstance(c, torch.Tensor) else consts.const(c))
        .to(device=x.device).to(dtype) for c in coefs)
    ic1_0 = state.ic1.to(dtype)
    ic2_0 = state.ic2.to(dtype)
    zeros = torch.zeros_like(xs)
    s1, s2 = linear_recurrence_2(
        2.0 * a1 - 1.0,
        -2.0 * a2 + zeros,
        2.0 * a2 + zeros,
        1.0 - 2.0 * a3,
        2.0 * a2 * xs,
        2.0 * a3 * xs,
        ic1_0,
        ic2_0,
    )
    # the filter taps v1/v2 are the trapezoidal midpoints of consecutive
    # integrator states: ic' = 2v - ic  =>  v = (ic' + ic) / 2
    v1 = 0.5 * (s1 + _prev_seq(s1, ic1_0))
    v2 = 0.5 * (s2 + _prev_seq(s2, ic2_0))
    y = m0 * xs + m1 * v1 + m2 * v2
    return TptState(s1[..., -1], s2[..., -1]), y.to(in_dtype)


# ---------------------------------------------------------------------------
# DC blocker (src/utils/dsp/filters/dc.rs)
# ---------------------------------------------------------------------------

DC_MODE_HZ = {"slow": 1.0, "default": 5.0, "fast": 20.0}


class DcState(NamedTuple):
    y1: torch.Tensor
    x1: torch.Tensor


def dc_state_init(shape=(), dtype=torch.float32, device="cpu") -> DcState:
    return DcState(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def dc_coefficient(sample_rate: int, mode: str = "default") -> float:
    """r = 1 - tau*hz/sr (reference: src/utils/dsp/filters/dc.rs:60-66)."""
    return 1.0 - (2.0 * math.pi * DC_MODE_HZ[mode] / float(sample_rate))


def dc_process(state: DcState, x: torch.Tensor, r, dtype=torch.float32):
    """y[n] = x[n] - x[n-1] + r*y[n-1] over ``x`` [..., n]; the feedforward
    difference is elementwise, the feedback one first-order recurrence.
    ``r`` broadcasts against ``x[..., :1]``."""
    in_dtype = x.dtype
    xs = x.to(dtype)
    diff = xs - _prev_seq(xs, state.x1.to(dtype))
    a = consts.as_device(r, dtype, x.device).expand_as(xs)
    y = linear_recurrence(a, diff, state.y1.to(dtype))
    return DcState(y1=y[..., -1], x1=xs[..., -1]), y.to(in_dtype)
