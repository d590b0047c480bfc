"""Block parameter smoothers with exact reference trajectories (port of
``phonic_tpu/ops/smoothing.py``).

Behavioural spec: reference src/utils/smoothing.rs.

Each smoother runs over a whole group of parameter rows at once: state
tensors are ``[P]``, a block's events ``[P, K]`` and the output ``[P, n]``
(the JAX package vmaps a scalar smoother over the rows; here the row
dimension is written out).  Scheduled events split a block into at most
K+1 segments; a short loop over segments propagates the smoother state to
each segment start, then the per-sample trajectory inside every segment is
an analytic function of the sample index.

The reference's ramp-termination ("snap") rule is modelled exactly for the
exponential and linear smoothers: ramping stops once the per-sample increment
falls below ``100 * f32::EPSILON`` (src/utils/smoothing.rs:196-216), after
which the *output* is the target while the internal state stays frozen.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import SMOOTHER_EPSILON, SMOOTHER_REFERENCE_SR
from . import consts


class SegmentEvents(NamedTuple):
    """One block's events for a group of rows."""

    times: torch.Tensor  # int [P, K]; >= block length for unused slots
    values: torch.Tensor  # float32 [P, K]
    # segments that can start inside the block: 1 + the most valid events
    # of any row.  Known on the host (events are lowered there), so the
    # per-sample evaluation skips the empty trailing segments.
    live: int


def live_segments(times: np.ndarray, n: int) -> int:
    """Segments that can start inside the block: 1 + the most valid events
    of any row of the host-lowered ``[P, K]`` event times."""
    return 1 + int((np.asarray(times) < n).sum(axis=1).max(initial=0))


def segment_events(times: np.ndarray, values: np.ndarray, n: int,
                   device) -> SegmentEvents:
    """Host-lowered ``[P, K]`` event arrays -> :class:`SegmentEvents`."""
    return SegmentEvents(
        torch.as_tensor(np.asarray(times, np.int64), device=device),
        torch.as_tensor(np.asarray(values, np.float32), device=device),
        live_segments(times, n))


def exp_alpha(inertia: float, sample_rate: int) -> float:
    """Effective per-sample coefficient: inertia scaled by the 44.1 kHz
    reference-rate compensation (src/utils/smoothing.rs:150)."""
    return inertia * (SMOOTHER_REFERENCE_SR / float(sample_rate))


def _segments(target, events: SegmentEvents, n: int):
    """Per-row segment starts, carried-forward targets, lengths, real-event
    flags and per-sample segment bounds, each ``[P, K+1]``."""
    p = target.shape[0]
    zero = torch.zeros((p, 1), dtype=events.times.dtype,
                       device=events.times.device)
    seg_start = torch.cat([zero, events.times], dim=1)
    valid = seg_start < n
    raw = torch.cat([target[:, None], events.values.to(target.dtype)], dim=1)
    # masked events (time >= n) keep the previous target
    cols = [raw[:, 0]]
    for k in range(1, raw.shape[1]):
        cols.append(torch.where(valid[:, k], raw[:, k], cols[-1]))
    seg_target = torch.stack(cols, dim=1)
    seg_end = torch.cat([seg_start[:, 1:], zero + n], dim=1)
    seg_len = seg_end - seg_start
    is_event = valid.clone()
    is_event[:, 0] = False
    return seg_start, seg_target, seg_len, is_event, seg_end


def _per_sample(seg_start, seg_end, live: int, n: int, value_fn):
    """Evaluate ``value_fn(s, j1)`` on each live segment's samples
    (``j1`` = 1-based local index, float ``[P, n]``) and assemble ``[P, n]``."""
    idx = torch.arange(n, dtype=torch.float32, device=seg_start.device)
    segs = seg_start.to(torch.float32)
    ends = seg_end.to(torch.float32)
    out = None
    for s in range(live):
        j1 = idx[None, :] - segs[:, s:s + 1] + 1.0
        val = value_fn(s, j1)
        if out is None:  # segment 0 always starts at sample 0
            out = torch.where(idx[None, :] < ends[:, :1], val, 0.0)
        else:
            mask = (j1 > 0.0) & (idx[None, :] < ends[:, s:s + 1])
            out = torch.where(mask, val, out)
    return out


# ---------------------------------------------------------------------------
# Exponential smoother (src/utils/smoothing.rs:122-233)
# ---------------------------------------------------------------------------


class ExpSmootherState(NamedTuple):
    current: torch.Tensor  # [P]
    target: torch.Tensor


def exp_smoother_init(value: torch.Tensor) -> ExpSmootherState:
    return ExpSmootherState(current=value, target=value)


def _exp_steps_to_freeze(delta, alpha, log1ma):
    """Number of ramp steps until |delta| * alpha * (1-alpha)^n <= eps."""
    ad = alpha * torch.abs(delta)
    n = torch.ceil(torch.log(torch.clamp(
        SMOOTHER_EPSILON / torch.clamp(ad, min=1e-38), min=1e-38)) / log1ma)
    return torch.where(ad <= SMOOTHER_EPSILON, 0.0, torch.clamp(n, min=0.0))


def exp_smoother_block(state: ExpSmootherState, events: SegmentEvents,
                       block_frames: int, alpha: float):
    """Render ``block_frames`` smoothed values per row, applying events
    sample-accurately.  Returns ``(new_state, values[P, block_frames])``.

    Matches ``next()`` semantics: the value at output sample n is the state
    *after* ramping at n (src/utils/smoothing.rs:21-28), and the output equals
    the target exactly once ramping has terminated."""
    n = block_frames
    dev = state.current.device
    alpha_t = consts.const(alpha, torch.float32, dev)
    log1ma = torch.log1p(-alpha_t)
    seg_start, seg_target, seg_len, is_event, seg_end = _segments(
        state.target, events, n)

    cur = state.current
    cur0s, nfreezes = [], []
    for s in range(seg_target.shape[1]):
        tgt = seg_target[:, s]
        n_freeze = _exp_steps_to_freeze(cur - tgt, alpha_t, log1ma)
        cur = torch.where(is_event[:, s] & (n_freeze == 0.0), tgt, cur)
        steps = torch.minimum(seg_len[:, s].to(torch.float32), n_freeze)
        cur0s.append(cur)
        nfreezes.append(n_freeze)
        cur = tgt + (cur - tgt) * torch.exp(log1ma * steps)

    def value(s, j1):
        tgt = seg_target[:, s:s + 1]
        ramped = tgt + (cur0s[s][:, None] - tgt) * torch.exp(
            log1ma * torch.clamp(j1, min=0.0))
        return torch.where(j1 <= nfreezes[s][:, None], ramped, tgt)

    out = _per_sample(seg_start, seg_end, events.live, n, value)
    return ExpSmootherState(current=cur, target=seg_target[:, -1]), out


# ---------------------------------------------------------------------------
# Linear smoother (src/utils/smoothing.rs:238-420)
# ---------------------------------------------------------------------------


class LinSmootherState(NamedTuple):
    current: torch.Tensor
    target: torch.Tensor
    step: torch.Tensor  # signed per-sample step currently in effect
    pending: torch.Tensor  # float32 count of remaining ramp steps


def lin_smoother_init(value: torch.Tensor, step: float = 0.01,
                      sample_rate: int = 48000) -> LinSmootherState:
    comp = SMOOTHER_REFERENCE_SR / float(sample_rate)
    return LinSmootherState(
        current=value, target=value,
        step=torch.full_like(value, step * comp),
        pending=torch.zeros_like(value))


def lin_smoother_block(state: LinSmootherState, events: SegmentEvents,
                       block_frames: int):
    """Linear fixed-step ramps.  ``set_target`` recomputes the signed step and
    a rounded pending-step count; the final step snaps exactly to the target
    (src/utils/smoothing.rs:300-380)."""
    n = block_frames
    step_mag = torch.abs(state.step)
    seg_start, seg_target, seg_len, is_event, seg_end = _segments(
        state.target, events, n)

    cur, pending, sgnstep = state.current, state.pending, state.step
    cur0s, pends, steps_ = [], [], []
    for s in range(seg_target.shape[1]):
        tgt = seg_target[:, s]
        ev = is_event[:, s]
        # only real events recompute the ramp (set_target,
        # src/utils/smoothing.rs:300-340)
        new_sgnstep = torch.where(cur > tgt, -step_mag, step_mag)
        new_pending = torch.clamp(torch.round((tgt - cur) / new_sgnstep),
                                  min=0.0)
        sgnstep = torch.where(ev, new_sgnstep, sgnstep)
        pending = torch.where(ev, new_pending, pending)
        cur = torch.where(ev & (pending == 0.0), tgt, cur)
        cur0s.append(cur)
        pends.append(pending)
        steps_.append(sgnstep)
        steps = torch.minimum(seg_len[:, s].to(torch.float32), pending)
        cur = torch.where((steps >= pending) & (pending > 0.0), tgt,
                          cur + sgnstep * steps)
        pending = pending - steps

    def value(s, j1):
        ramped = cur0s[s][:, None] + steps_[s][:, None] * j1
        return torch.where(j1 < pends[s][:, None], ramped,
                           seg_target[:, s:s + 1])

    out = _per_sample(seg_start, seg_end, events.live, n, value)
    new_state = LinSmootherState(current=cur, target=seg_target[:, -1],
                                 step=sgnstep, pending=pending)
    return new_state, out


# ---------------------------------------------------------------------------
# Spring smoother (src/utils/smoothing.rs:424-545)
# ---------------------------------------------------------------------------


class SpringSmootherState(NamedTuple):
    current: torch.Tensor
    velocity: torch.Tensor
    target: torch.Tensor


def spring_smoother_init(value: torch.Tensor) -> SpringSmootherState:
    return SpringSmootherState(current=value,
                               velocity=torch.zeros_like(value), target=value)


def spring_omega(duration_samples: float = 4410.0) -> float:
    """~100 ms default; (1+5.5)e^-5.5 ~= 3% settling
    (src/utils/smoothing.rs:440-447)."""
    return 5.5 / float(duration_samples)


def spring_smoother_block(state: SpringSmootherState, events: SegmentEvents,
                          block_frames: int, omega: float, sample_rate: int):
    """Critically-damped spring: per-sample update
    ``v += (t-c)k - v d; c += v`` with k=w'^2, d=2w'
    (src/utils/smoothing.rs:512-520), evaluated in closed form via the
    eigen-decomposition of the 2x2 update matrix on (v, c-t).  The
    termination epsilon applies per sample on the analytic trajectory."""
    n = block_frames
    dev = state.current.device
    w = omega * (SMOOTHER_REFERENCE_SR / float(sample_rate))
    k = w * w
    d = 2.0 * w
    # update matrix on (v, e) with e = current - target
    m11, m12 = 1.0 - d, -k
    m21, m22 = 1.0 - d, 1.0 - k
    tr = m11 + m22
    disc = math.sqrt(max(tr * tr - 4.0 * (1.0 - d), 0.0))
    l1 = (tr + disc) / 2.0
    l2 = (tr - disc) / 2.0
    inv_dl = 1.0 / (l1 - l2) if disc > 0 else 0.0
    l1_t = consts.const(l1, torch.float32, dev)
    l2_t = consts.const(l2, torch.float32, dev)

    def mat_pow_apply(p, v0, e0):
        """(v_p, e_p) = M^p (v0, e0) via
        M^p = (l1^p (M-l2 I) - l2^p (M-l1 I)) / (l1-l2)."""
        l1p = torch.exp(torch.log(l1_t) * p) if l1 > 0 else torch.pow(l1_t, p)
        l2p = torch.pow(torch.sign(l2_t), p) * torch.exp(
            torch.log(torch.abs(l2_t) + 1e-38) * p)
        c1 = l1p * inv_dl
        c2 = l2p * inv_dl
        a_v = (m11 - l2) * v0 + m12 * e0
        a_e = m21 * v0 + (m22 - l2) * e0
        b_v = (m11 - l1) * v0 + m12 * e0
        b_e = m21 * v0 + (m22 - l1) * e0
        return c1 * a_v - c2 * b_v, c1 * a_e - c2 * b_e

    seg_start, seg_target, seg_len, _, seg_end = _segments(
        state.target, events, n)
    v, c = state.velocity, state.current
    v0s, e0s = [], []
    for s in range(seg_target.shape[1]):
        tgt = seg_target[:, s]
        e = c - tgt  # set_target preserves velocity (smoothing.rs:528-531)
        v0s.append(v)
        e0s.append(e)
        v, e_end = mat_pow_apply(seg_len[:, s].to(torch.float32), v, e)
        c = tgt + e_end

    def value(s, j1):
        v_j, e_j = mat_pow_apply(torch.clamp(j1, min=0.0), v0s[s][:, None],
                                 e0s[s][:, None])
        settled = (torch.abs(v_j) <= SMOOTHER_EPSILON) & (
            torch.abs(e_j) <= SMOOTHER_EPSILON)
        tgt = seg_target[:, s:s + 1]
        return torch.where(settled, tgt, tgt + e_j)

    out = _per_sample(seg_start, seg_end, events.live, n, value)
    return SpringSmootherState(current=c, velocity=v,
                               target=seg_target[:, -1]), out


def step_targets(current: torch.Tensor, events: SegmentEvents,
                 ramps: torch.Tensor, n: int):
    """Un-smoothed per-sample targets for smoothing=None parameters: stepped
    at event times, or linearly interpolated across a segment when the event
    ending it is flagged as a ramp (speed glides, events.py).  Returns
    (end_value[P], values[P, n]).

    value[i] = current + sum_k d_k * g_k(i), with d_k the value delta at
    event k and g_k a unit step (jump) or clipped ramp; slots past the last
    valid event have d_k == 0 and are skipped."""
    t = events.times
    valid = t < n
    vals_k = events.values.to(current.dtype)
    cols = [current]
    for k in range(t.shape[1]):
        cols.append(torch.where(valid[:, k], vals_k[:, k], cols[-1]))
    seg_vals = torch.stack(cols, dim=1)  # [P, K+1]
    d = seg_vals[:, 1:] - seg_vals[:, :-1]
    prev_t = torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], dim=1)
    inv_span = 1.0 / torch.clamp(t - prev_t, min=1).to(torch.float32)
    idx = torch.arange(n, dtype=torch.float32, device=current.device)
    vals = current[:, None].expand(-1, n).to(torch.float32)
    for k in range(events.live - 1):
        ramp_g = torch.clamp((idx[None, :] - prev_t[:, k:k + 1])
                             * inv_span[:, k:k + 1], 0.0, 1.0)
        jump_g = (idx[None, :] >= t[:, k:k + 1]).to(torch.float32)
        vals = vals + d[:, k:k + 1] * torch.where(
            ramps[:, k:k + 1] > 0, ramp_g, jump_g)
    return seg_vals[:, -1], vals
