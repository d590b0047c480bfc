"""Musical unit conversions (port of ``phonic_tpu/ops/convert.py``; the
slice needs only the pan law).

Behavioural spec: reference src/utils.rs:55-63.
"""

from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)


def panning_factors(pan: torch.Tensor):
    """[-1, 1] pan position -> constant-power (left, right) gains, normalised
    so that centre pan gives unity (reference: src/utils.rs:55-63)."""
    pan = torch.clamp(pan, -1.0, 1.0)
    normalized = (pan + 1.0) * 0.5
    left = torch.sqrt(1.0 - normalized) * _SQRT2
    right = torch.sqrt(normalized) * _SQRT2
    return left, right
