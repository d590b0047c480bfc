"""Compensated float32 arithmetic (double-single) for long-running state
(port of ``phonic_tpu/ops/precision.py``).

Long-lived accumulators (playback positions) that must stay sample-accurate
over hours use a (hi, lo) float32 pair with error-free transformations.
"""

from __future__ import annotations

import numpy as np


def recip32(c) -> float:
    """The float32 reciprocal of a constant, as a Python float.

    Where the JAX package divides a float32 array by a constant, XLA
    multiplies by this reciprocal instead (and folds it into a constant
    factor before it, ``x * a / b`` -> ``x * f32(a * recip32(b))``).  The
    port writes the product out: it then rounds as JAX does, and as the
    card does too (CUDA's division by a host scalar is also a product with
    its reciprocal, while the CPU's divides)."""
    return float(np.float32(1.0) / np.float32(c))


def two_sum(a, b):
    """Error-free transformation: a + b = s + e exactly."""
    s = a + b
    bp = s - a
    ap = s - bp
    e = (a - ap) + (b - bp)
    return s, e


def fast_two_sum(a, b):
    """Requires |a| >= |b| (or a == 0): a + b = s + e exactly."""
    s = a + b
    e = b - (s - a)
    return s, e


def ds_add(hi, lo, x):
    """(hi + lo) + x -> renormalized (hi, lo)."""
    s, e = two_sum(hi, x)
    return fast_two_sum(s, e + lo)
