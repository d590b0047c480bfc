"""Attack/release envelope coefficients (port of ``follower_coef`` and
``follower_alpha`` from ``phonic_tpu/ops/envelope.py``) and the dB detector
the gate and the compressor feed them.

Behavioural spec: reference src/utils/dsp/envelope.rs — a one-pole
smoother whose coefficient switches between attack and release depending
on whether the input is above or below the current envelope.  The
recurrences that use these coefficients live in ops/follower.py.
"""

from __future__ import annotations

import math

import torch

LN10_20 = 20.0 / math.log(10.0)  # dB = LN10_20 * ln(amplitude)


def peak_to_db(peak: torch.Tensor) -> torch.Tensor:
    """A detector's peak amplitude in dB; -120 dB at or below 1e-6
    (reference: src/effect/gate.rs, src/effect/compressor.rs)."""
    return torch.where(peak > 1e-6,
                       LN10_20 * torch.log(torch.clamp(peak, min=1e-7)),
                       -120.0)


def follower_coef(time_secs, sample_rate: int, dtype=torch.float32):
    """coef = exp(-1 / (t * sr)); 0 when t <= 0
    (reference: src/utils/dsp/envelope.rs:27-41).  Coefficients this close
    to 1 lose about half their distance-to-1 precision in float32; use
    :func:`follower_alpha`, the 1 - coef form, for the followers."""
    t = torch.as_tensor(time_secs, dtype=dtype)
    return torch.where(
        t > 0.0, torch.exp(-1.0 / torch.clamp(t * float(sample_rate), min=1e-9)),
        torch.zeros_like(t))


def follower_alpha(time_secs, sample_rate: int, dtype=torch.float32):
    """a = 1 - coef computed directly as -expm1(-1/(t*sr)), which keeps full
    relative precision in float32 (the update env += a*(x-env) is
    algebraically env = x + coef*(env-x)).  a = 1 (instant) when t <= 0."""
    t = torch.as_tensor(time_secs, dtype=dtype)
    return torch.where(
        t > 0.0, -torch.expm1(-1.0 / torch.clamp(t * float(sample_rate), min=1e-9)),
        torch.ones_like(t))


def follower_block(y0, x, attack_coef, release_coef, axis: int = -1):
    """Run the attack / release follower ``y = x + coef * (y - x)``, coef
    the attack one where ``x > y``, over a block, one sample at a time.
    x: samples along ``axis`` with any leading batch dims; y0: state shaped
    like x without the sample axis.  Returns (y_end, y)."""
    x = torch.as_tensor(x)
    xm = x.movedim(axis, 0)
    attack = torch.as_tensor(attack_coef, dtype=x.dtype)
    release = torch.as_tensor(release_coef, dtype=x.dtype)
    y = torch.as_tensor(y0, dtype=x.dtype).expand(xm.shape[1:]).clone()
    ys = torch.empty_like(xm)
    for n in range(xm.shape[0]):
        coef = torch.where(xm[n] > y, attack, release)
        y = xm[n] + coef * (y - xm[n])
        ys[n] = y
    return y, ys.movedim(0, axis)
