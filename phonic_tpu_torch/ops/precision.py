"""Compensated float32 arithmetic (double-single) for long-running state
(port of ``phonic_tpu/ops/precision.py``).

Long-lived accumulators (playback positions) that must stay sample-accurate
over hours use a (hi, lo) float32 pair with error-free transformations.
"""

from __future__ import annotations


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
