"""Musical unit conversions (port of ``phonic_tpu/ops/convert.py``: the
pan law, and linear -> dB for host-side levels).

Behavioural spec: reference src/utils.rs:25-63.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_SQRT2 = math.sqrt(2.0)
_LIN_TO_DB = 20.0 / math.log(10.0)
_DB_TO_LIN = math.log(10.0) / 20.0
# the floor of the dB scale (reference: src/utils.rs:25-36)
MINUS_INF_DB = -200.0


def linear_to_db(value) -> np.ndarray:
    """Linear gain factor -> dB, in float32 on the host.  Values <= 1e-12
    map to -200 dB; exactly 1.0 maps to exactly 0 dB (reference:
    src/utils.rs:25-36)."""
    value = np.asarray(value, np.float32)
    with np.errstate(invalid="ignore"):
        db = np.log(np.maximum(value, np.float32(1e-30))) * np.float32(_LIN_TO_DB)
    db = np.where(value > 1e-12, db, np.float32(MINUS_INF_DB))
    db = np.where(value == 1.0, np.float32(0.0), db)
    return np.where(value < 0.0, np.float32(np.nan), db).astype(np.float32)


def panning_factors(pan: torch.Tensor):
    """[-1, 1] pan position -> constant-power (left, right) gains, normalised
    so that centre pan gives unity (reference: src/utils.rs:55-63)."""
    pan = torch.clamp(pan, -1.0, 1.0)
    normalized = (pan + 1.0) * 0.5
    left = torch.sqrt(1.0 - normalized) * _SQRT2
    right = torch.sqrt(normalized) * _SQRT2
    return left, right


def db_to_linear(value) -> torch.Tensor:
    """dB -> linear gain factor, float32.  <= -200 dB maps to 0; exactly
    0 dB maps to exactly 1.0 (reference: src/utils.rs:40-51)."""
    value = torch.as_tensor(value, dtype=torch.float32)
    lin = torch.exp(value * _DB_TO_LIN)
    lin = torch.where(value > MINUS_INF_DB, lin, 0.0)
    return torch.where(value == 0.0, 1.0, lin)


def pitch_from_note(midi_note) -> torch.Tensor:
    """MIDI note -> Hz, equal temperament, A4 (note 69) = 440 Hz
    (reference: src/utils.rs:75-79)."""
    note = torch.as_tensor(midi_note, dtype=torch.float32)
    return 440.0 * torch.exp2((note - 69.0) / 12.0)


def speed_from_note(midi_note) -> torch.Tensor:
    """MIDI note -> playback speed relative to middle C (note 60)
    (reference: src/utils.rs:67-71)."""
    note = torch.as_tensor(midi_note, dtype=torch.float32)
    return torch.exp2((note - 60.0) / 12.0)
