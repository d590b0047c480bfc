"""AHDSR envelope, evaluated in closed form (port of
``phonic_tpu/ops/ahdsr.py``).

Behavioural spec: reference src/utils/ahdsr.rs (stage machine :442-556,
rates :160-265, curve scaling :325-346).

Every stage is a linear ramp with a precomputable duration, so the envelope
value at any sample is a closed-form function of (runs since note-on, runs
since note-off, velocity volume): a block of envelope values for a bank of
voices is elementwise math over tensors, no scan.  Parameters and inputs
are tensors that broadcast together (a voice dimension is a leading
dimension of each); a block adds a trailing sample dimension.

Reference quirks reproduced deliberately:
  * release ends by snapping to 0 once the value falls below 0.001 (-60 dB)
    (src/utils/ahdsr.rs:506-510);
  * release duration is level-independent: the decrement is
    ``release_level * release_rate`` (src/utils/ahdsr.rs:504);
  * "release scaling" is a no-op in the reference (progress always computes
    to 0 at src/utils/ahdsr.rs:545-552), so it is a no-op here.

Deliberate deviations (as in the JAX package):
  * values are exact closed forms, not f32 accumulation;
  * decay curve scaling always treats the level decay started from as the
    curve anchor (the reference reads a stale ``target_volume`` there,
    src/utils/ahdsr.rs:520-536).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Union

import numpy as np
import torch

SILENCE = 0.001  # -60 dB release cutoff (src/utils/ahdsr.rs:377)
_E_DIV_2 = math.e / 2.0
_EPS = float(torch.finfo(torch.float32).eps)
_INF = float("inf")

Scalar = Union[float, torch.Tensor]


class AhdsrParams(NamedTuple):
    """Per-sample rates (reference: src/utils/ahdsr.rs:160-265), float32
    tensors, batched over voices by their shapes.  The curve scalings may
    stay Python floats: a scaling of 0 (linear) then costs nothing."""

    attack_rate: torch.Tensor  # volume units / sample; inf = skip attack
    hold_samples: torch.Tensor  # float samples
    decay_rate: torch.Tensor  # (1 - sustain) / decay-samples; inf = skip
    sustain: torch.Tensor  # 0..1
    release_rate: torch.Tensor  # 1 / release-samples; inf = cut
    attack_scaling: Scalar  # -1..1, 0 = linear
    decay_scaling: Scalar


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _scalar(x: Scalar) -> Scalar:
    """A float32 tensor as it is; a number rounded to float32 and kept a
    Python float, so that it costs no host-to-device copy on the card."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return float(np.float32(x))


def ahdsr_params(sample_rate: int, attack_secs, hold_secs, decay_secs,
                 sustain_level, release_secs, attack_scaling: Scalar = 0.0,
                 decay_scaling: Scalar = 0.0) -> AhdsrParams:
    attack_secs, hold_secs, decay_secs, sustain_level, release_secs = map(
        _f32, (attack_secs, hold_secs, decay_secs, sustain_level, release_secs))
    sr = float(sample_rate)
    return AhdsrParams(
        attack_rate=torch.where(
            attack_secs > 0.0,
            1.0 / torch.clamp(attack_secs * sr, min=1e-9), _INF),
        hold_samples=hold_secs * sr,
        decay_rate=torch.where(
            decay_secs > 0.0,
            (1.0 - sustain_level) / torch.clamp(decay_secs * sr, min=1e-9),
            _INF),
        sustain=sustain_level,
        release_rate=torch.where(
            release_secs > 0.0,
            1.0 / torch.clamp(release_secs * sr, min=1e-9), _INF),
        attack_scaling=attack_scaling,
        decay_scaling=decay_scaling,
    )


def apply_scaling(value: torch.Tensor, scaling: Scalar) -> torch.Tensor:
    """Curve shaping x -> x^(1 + s^(e/2)*16) (positive scaling: fast start /
    logarithmic; negative: slow start / exponential)
    (reference: src/utils/ahdsr.rs:325-346)."""
    if not isinstance(scaling, torch.Tensor):
        if scaling == 0.0:
            return value  # linear: the formula below selects ``value`` too
        scaling = value.new_full((), _scalar(scaling))
    s = -scaling.to(torch.float32)
    mag = torch.abs(s)
    exponent = 1.0 + torch.pow(torch.clamp(mag, min=1e-9), _E_DIV_2) * 16.0
    pos = torch.pow(torch.clamp(value, min=0.0), exponent)
    neg = 1.0 - torch.pow(torch.clamp(1.0 - value, min=0.0), exponent)
    shaped = torch.where(s > 0.0, pos, neg)
    return torch.where((s == 0.0) | (value == 0.0), value, shaped)


def _raw_value(p: AhdsrParams, volume: Scalar, c: torch.Tensor):
    """Pre-scaling envelope after ``c`` runs since note-on (c >= 1), while the
    note is held.  Also returns the stage id (0 attack / 1 hold / 2 decay /
    3 sustain) *after* run c — scaling selects on the post-run stage."""
    volume = _scalar(volume)
    skip_attack = torch.isinf(p.attack_rate)
    n_attack = torch.where(
        skip_attack, 0.0,
        torch.ceil(volume / torch.where(skip_attack, 1.0, p.attack_rate)))
    n_hold = torch.ceil(p.hold_samples)
    skip_decay = torch.isinf(p.decay_rate)
    # Reference quirk (src/utils/ahdsr.rs:470-478): with a zero decay time the
    # hold stage transitions straight to Sustain *without touching output*, so
    # the envelope sustains at the attack peak; only the hold==0 path reaches
    # the Decay stage and clamps to the sustain level in one run.
    sustain_level = torch.where(skip_decay & (n_hold > 0), volume, p.sustain)
    dist = torch.abs(volume - sustain_level)
    n_decay = torch.where(
        skip_decay, torch.where(dist > 0.0, 1.0, 0.0),
        torch.ceil(dist / torch.where(skip_decay, 1.0, p.decay_rate)))

    attack_val = torch.clamp(c * p.attack_rate, max=volume)
    c_decay = c - n_attack - n_hold
    above = volume > sustain_level
    toward = torch.where(above, -1.0, 1.0)
    decay_val = volume + toward * c_decay * torch.where(skip_decay, dist,
                                                        p.decay_rate)
    decay_val = torch.where(above, torch.maximum(decay_val, sustain_level),
                            torch.minimum(decay_val, sustain_level))

    in_attack = c <= n_attack
    in_hold = ~in_attack & (c <= n_attack + n_hold)
    in_decay = ~in_attack & ~in_hold & (c_decay <= n_decay)

    raw = torch.where(in_attack, attack_val, torch.where(
        in_hold, volume, torch.where(in_decay, decay_val, sustain_level)))
    # post-run stage: attack's final run already switched to hold/decay
    stage = torch.where(c < n_attack, 0, torch.where(
        in_hold | (in_attack & (n_hold > 0)), 1, torch.where(in_decay, 2, 3)))
    return raw, stage


def _display_value(p: AhdsrParams, volume: Scalar, c: torch.Tensor):
    """Post-scaling envelope value after ``c`` held runs."""
    raw, stage = _raw_value(p, volume, c)
    volume = _scalar(volume)
    vol = (torch.clamp(volume, min=_EPS) if isinstance(volume, torch.Tensor)
           else max(volume, _EPS))
    # attack scaling (src/utils/ahdsr.rs:515-519)
    att = apply_scaling(raw / vol, p.attack_scaling) * vol
    # decay scaling, anchored at the decay start level (module docstring)
    rng = torch.clamp(torch.abs(vol - p.sustain), min=_EPS)
    prog = apply_scaling(torch.abs(vol - raw) / rng, p.decay_scaling) * rng
    dec = torch.where(vol > p.sustain, vol - prog, vol + prog)
    out = torch.where(stage == 0, att, torch.where(stage == 2, dec, raw))
    return out, raw


def release_level(p: AhdsrParams, volume: Scalar,
                  release_at: torch.Tensor) -> torch.Tensor:
    """The level the release decays from: the envelope at the note-off run
    (raw == display there, release scaling being a no-op); 0 when the note
    was released before it started."""
    level, _ = _display_value(p, volume, torch.clamp(release_at, min=1.0))
    return torch.where(release_at < 1.0, 0.0, level)


def _envelope(p: AhdsrParams, volume: Scalar, c: torch.Tensor,
              release_at: torch.Tensor, rel_level: torch.Tensor):
    started = c >= 1.0
    held_val, _ = _display_value(p, volume, torch.clamp(c, min=1.0))
    r = c - release_at
    cut = torch.isinf(p.release_rate)
    rel_val = rel_level * (1.0 - r * torch.where(cut, 1.0, p.release_rate))
    rel_val = torch.where(cut | (rel_val <= SILENCE), 0.0, rel_val)
    # note_off with an already-silent envelope goes straight to idle
    rel_val = torch.where(rel_level <= _EPS, 0.0, rel_val)
    out = torch.where(r > 0.0, rel_val, torch.where(started, held_val, 0.0))
    return out.to(torch.float32)


def ahdsr_block(p: AhdsrParams, volume: Scalar, note_age0, release_at,
                n: int) -> torch.Tensor:
    """Envelope values for one block.

    volume:     velocity volume at note-on.
    note_age0:  runs completed before this block (int; <0 = note not started;
                sample i of the block is run ``note_age0 + i + 1``).
    release_at: run count after which note-off occurred (inf = held).
    ``note_age0``, ``release_at`` and the parameters broadcast against the
    samples ``[n]`` (a voice dimension leads, e.g. ``[V, 1]``).  Returns
    float32 ``[..., n]``."""
    release_at = _f32(release_at)
    i = torch.arange(n, dtype=torch.float32, device=release_at.device)
    c = torch.as_tensor(note_age0, device=release_at.device).to(
        torch.float32) + i + 1.0
    return _envelope(p, volume, c, release_at,
                     release_level(p, volume, release_at))


def ahdsr_values(p: AhdsrParams, volume: Scalar, ages, release_at,
                 rel_level=None) -> torch.Tensor:
    """Envelope values at explicit per-sample ages (int, runs since note-on
    minus one) with a release_at that broadcasts against them.  Used where
    lane-mixed ages are not contiguous.  ``rel_level``, when given, is the
    :func:`release_level` of each sample's ``release_at`` (callers that
    select between a few release points per voice compute it per point)."""
    ages = torch.as_tensor(ages)
    release_at = _f32(release_at).to(ages.device)
    c = ages.to(torch.float32) + 1.0
    if rel_level is None:
        rel_level = release_level(p, volume, release_at)
    return _envelope(p, volume, c, release_at, rel_level)


def ahdsr_release_duration(p: AhdsrParams) -> torch.Tensor:
    """Runs until the release hits the -60 dB cutoff from full level —
    used by voice allocators to retire voices."""
    return torch.where(torch.isinf(p.release_rate), 0.0,
                       torch.ceil((1.0 - SILENCE) / p.release_rate))
