"""Plain PyTorch DSP for the benchmark's reference renders.

Everything here is written from the behaviour the engine documents
(sample-accurate smoothed parameters, a 4-point Hermite read at positions
that advance by the speed per output frame, TPT biquads and SVFs, LFO-swept
delay lines), in float64 by default, one plain tensor expression at a time.
It imports nothing of the program under test and takes nothing it made.

Two things follow the engine's float32 definition on purpose, because they
are discrete choices and not rounding: a source's read positions within a
block (``float32 base + s0 * i + residual``, where a float32 product decides
the frame a tap lands on) and the reverb's vibrato tap (``floor`` of a
float32 offset).  Every audio value is computed in ``dtype``: float64 for
the reference, bfloat16 for the control that stands one precision below the
engine's float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)
# a smoothed parameter stops ramping once its per-sample increment falls
# below 100 float32 epsilons; its output is then the target
SMOOTH_EPS = 100.0 * F32_EPS
SMOOTH_REF_SR = 44100.0
DEFAULT_INERTIA = 1.0 / 256.0
LINEAR_STEP = 0.01


# ---------------------------------------------------------------------------
# event rows
# ---------------------------------------------------------------------------

def event_rows(rows: list, n: int, device, k: int = None):
    """Per-row in-block events ``[(offset, value, ramp), ...]`` -> times
    int64 [R, K] (``n`` past the last event), values float64 [R, K], ramp
    flags bool [R, K].  Events of a row are in time order."""
    k = max([len(r) for r in rows] + [1]) if k is None else k
    t = np.full((len(rows), k), n, np.int64)
    v = np.zeros((len(rows), k), np.float64)
    r = np.zeros((len(rows), k), bool)
    for i, evs in enumerate(rows):
        for j, (tt, vv, rr) in enumerate(evs):
            t[i, j], v[i, j], r[i, j] = tt, vv, rr
    as_t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return as_t(t), as_t(v), as_t(r)


def _segments(target, times, values, n):
    """Segment starts, ends and targets [R, K+1]: segment 0 starts at 0
    with the carried target, segment s at event s-1's time with its value."""
    r = target.shape[0]
    zero = torch.zeros((r, 1), dtype=torch.int64, device=target.device)
    starts = torch.cat([zero, times], dim=1)
    ends = torch.cat([times, zero + n], dim=1)
    cols = [target]
    for j in range(times.shape[1]):  # a padded slot keeps the last target
        cols.append(torch.where(times[:, j] < n, values[:, j].to(
            target.dtype), cols[-1]))
    return starts, ends, torch.stack(cols, dim=1)


# ---------------------------------------------------------------------------
# smoothers (one call renders one block of every row)
# ---------------------------------------------------------------------------

def exp_alpha(sample_rate: int, inertia: float = DEFAULT_INERTIA) -> float:
    return inertia * SMOOTH_REF_SR / float(sample_rate)


def exp_smooth(cur, target, times, values, n: int, alpha: float):
    """Exponential smoother: each sample moves ``alpha`` of the way to the
    target and outputs the new value, until the increment would be below
    SMOOTH_EPS; from then on it outputs the target and its state freezes.
    An event whose target is already within that reach jumps to it.
    Returns (cur, target, values [R, n])."""
    starts, ends, tg = _segments(target, times, values, n)
    idx = torch.arange(n, device=cur.device)
    log1ma = math.log1p(-alpha)
    out = torch.empty((cur.shape[0], n), dtype=cur.dtype, device=cur.device)
    for s in range(tg.shape[1]):
        t = tg[:, s]
        ad = alpha * torch.abs(cur - t)
        ad = ad.double()
        frz = torch.where(
            ad <= SMOOTH_EPS, torch.zeros_like(ad),
            torch.clamp(torch.ceil(torch.log(SMOOTH_EPS / torch.clamp(
                ad, min=1e-300)) / log1ma), min=0.0))
        st, en = starts[:, s:s + 1], ends[:, s:s + 1]
        if s > 0:
            cur = torch.where((st[:, 0] < n) & (frz == 0), t, cur)
        j1 = (idx[None, :] - st + 1).double()  # a sample count: exact
        ramped = t[:, None] + (cur - t)[:, None] * torch.exp(
            log1ma * torch.clamp(j1, min=0.0)).to(cur.dtype)
        val = torch.where(j1 <= frz[:, None].double(), ramped, t[:, None])
        out = torch.where((idx[None, :] >= st) & (idx[None, :] < en), val, out)
        steps = torch.minimum((en - st)[:, 0].clamp(min=0).double(),
                              frz.double())
        cur = t + (cur - t) * torch.exp(log1ma * steps).to(cur.dtype)
    return cur, tg[:, -1], out


def linear_smooth(cur, target, step, pending, times, values, n: int):
    """Linear smoother: an event sets a signed step of fixed size and a
    rounded count of steps; the last step lands on the target.  Returns
    (cur, target, step, pending, values [R, n])."""
    starts, ends, tg = _segments(target, times, values, n)
    idx = torch.arange(n, device=cur.device)
    mag = torch.abs(step)
    out = torch.empty((cur.shape[0], n), dtype=cur.dtype, device=cur.device)
    for s in range(tg.shape[1]):
        t = tg[:, s]
        st, en = starts[:, s:s + 1], ends[:, s:s + 1]
        if s > 0:
            real = st[:, 0] < n
            new_step = torch.where(cur > t, -mag, mag)
            new_pend = torch.clamp(torch.round((t - cur) / new_step), min=0.0)
            step = torch.where(real, new_step, step)
            pending = torch.where(real, new_pend, pending)
            cur = torch.where(real & (pending == 0), t, cur)
        j1 = (idx[None, :] - st + 1).double()  # a sample count: exact
        val = torch.where(j1 < pending[:, None].double(), cur[:, None] + (
            step[:, None].double() * j1).to(cur.dtype), t[:, None])
        out = torch.where((idx[None, :] >= st) & (idx[None, :] < en), val, out)
        steps = torch.minimum((en - st)[:, 0].clamp(min=0).to(cur.dtype),
                              pending)
        cur = torch.where((steps >= pending) & (pending > 0), t,
                          cur + step * steps)
        pending = pending - steps
    return cur, tg[:, -1], step, pending, out


def stepped(cur, times, values, ramps, n: int):
    """A parameter without smoothing, in float32 as the engine defines it
    (it feeds the float32 read positions): the value jumps at each event,
    or, where the event is a ramp knot, moves linearly from the previous
    event (or the block start) to reach the knot's value at its time; the
    value is the carried one plus each event's step times its unit jump or
    clipped ramp.  Returns (end value, values [R, n]), float32."""
    f32 = torch.float32
    r, k = times.shape
    live = times < n
    cols = [cur.to(f32)]
    for j in range(k):
        cols.append(torch.where(live[:, j], values[:, j].to(f32), cols[-1]))
    seg = torch.stack(cols, dim=1)
    d = seg[:, 1:] - seg[:, :-1]
    prev_t = torch.cat([torch.zeros_like(times[:, :1]), times[:, :-1]], 1)
    inv = 1.0 / torch.clamp(times - prev_t, min=1).to(f32)
    idx = torch.arange(n, dtype=f32, device=cur.device)
    out = cur.to(f32)[:, None].expand(r, n)
    for j in range(int(live.sum(1).max().item()) if k else 0):
        ramp = torch.clamp((idx[None, :] - prev_t[:, j:j + 1]) * inv[:, j:j + 1],
                           0.0, 1.0)
        jump = (idx[None, :] >= times[:, j:j + 1]).to(f32)
        out = out + d[:, j:j + 1] * torch.where(ramps[:, j:j + 1], ramp, jump)
    return seg[:, -1], out


# ---------------------------------------------------------------------------
# reads
# ---------------------------------------------------------------------------

def hermite_read(table, rows, pos, dtype):
    """4-point 3rd-order Hermite (Niemitalo's x-form) read of ``table``
    [S, ch, F] (zero outside [0, F)) for each row's source ``rows`` [R] at
    float32 positions ``pos`` [R, n].  Returns [R, ch, n] in ``dtype``."""
    f = table.shape[-1]
    k = torch.floor(pos)
    frac = (pos - k).to(dtype)[:, None, :]
    ki = k.to(torch.int64)
    src = table.to(dtype)[rows]

    def tap(o):
        i = ki + o
        ok = ((i >= 0) & (i < f))[:, None, :]
        idx = i.clamp(0, f - 1)[:, None, :].expand(-1, src.shape[1], -1)
        return torch.where(ok, torch.gather(src, 2, idx),
                           torch.zeros((), dtype=dtype, device=src.device))

    ym1, y0, y1, y2 = tap(-1), tap(0), tap(1), tap(2)
    c1 = 0.5 * (y1 - ym1)
    c2 = ym1 - 2.5 * y0 + 2.0 * y1 - 0.5 * y2
    c3 = 0.5 * (y2 - ym1) + 1.5 * (y0 - y1)
    return ((c3 * frac + c2) * frac + c1) * frac + y0


def pan_gains(pan):
    """Constant-power pan, unity at the centre: (left, right)."""
    x = (torch.clamp(pan, -1.0, 1.0) + 1.0) * 0.5
    return torch.sqrt(1.0 - x) * math.sqrt(2.0), torch.sqrt(x) * math.sqrt(2.0)


# ---------------------------------------------------------------------------
# recurrences
# ---------------------------------------------------------------------------

def affine2_scan(a11, a12, a21, a22, b1, b2, s1, s2):
    """``s[t] = A[t] s[t-1] + b[t]`` along the last axis from (s1, s2), by
    recursive doubling: after the step with offset d, element t holds the
    composition of the maps t-2d+1..t.  Returns the states (s1, s2)."""
    n = b1.shape[-1]
    a11, a12, a21, a22, b1, b2 = torch.broadcast_tensors(
        a11, a12, a21, a22, b1, b2)
    a = torch.stack([torch.stack([a11, a12], -1),
                     torch.stack([a21, a22], -1)], -2)  # [..., n, 2, 2]
    b = torch.stack([b1, b2], -1)[..., None]  # [..., n, 2, 1]
    def mm(x, y):  # batched 2x2 products, elementwise (no BLAS call)
        return (x[..., :, :, None] * y[..., None, :, :]).sum(-2)

    d = 1
    while d < n:
        later = a[..., d:, :, :]
        b = torch.cat([b[..., :d, :, :],
                       mm(later, b[..., :-d, :, :]) + b[..., d:, :, :]], -3)
        a = torch.cat([a[..., :d, :, :], mm(later, a[..., :-d, :, :])], -3)
        d *= 2
    s = mm(a, torch.stack([s1, s2], -1)[..., None, :, None]) + b
    return s[..., 0, 0], s[..., 1, 0]


def tpt(state, x, a1, a2, a3, m0, m1, m2):
    """Trapezoidal state-variable core over x [..., n]: per sample
    ``v3 = x - ic2; v1 = a1 ic1 + a2 v3; v2 = ic2 + a2 ic1 + a3 v3;
    ic1 = 2 v1 - ic1; ic2 = 2 v2 - ic2; y = m0 x + m1 v1 + m2 v2``.
    Coefficients broadcast against x.  Returns ((ic1, ic2), y)."""
    ic1, ic2 = state
    s1, s2 = affine2_scan(2.0 * a1 - 1.0, -2.0 * a2, 2.0 * a2, 1.0 - 2.0 * a3,
                          2.0 * a2 * x, 2.0 * a3 * x, ic1, ic2)
    p1 = torch.cat([ic1[..., None], s1[..., :-1]], -1)
    p2 = torch.cat([ic2[..., None], s2[..., :-1]], -1)
    y = m0 * x + m1 * 0.5 * (s1 + p1) + m2 * 0.5 * (s2 + p2)
    return (s1[..., -1], s2[..., -1]), y


def biquad(kind: str, sr: int, cutoff, q, gain_db=None):
    """Cytomic SVF-form biquad coefficients (a1, a2, a3, m0, m1, m2) for a
    lowpass, bell, low shelf or high shelf."""
    g = torch.tan(math.pi * cutoff / sr)
    one = torch.ones_like(g)
    if kind == "lowpass":
        k = 1.0 / q + 0.0 * g
    else:
        a = torch.pow(10.0, gain_db / 40.0)
        k = 1.0 / (q * a) if kind == "bell" else 1.0 / q + 0.0 * g
        if kind == "lowshelf":
            g = g / torch.sqrt(a)
        elif kind == "highshelf":
            g = g * torch.sqrt(a)
    a1 = 1.0 / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2
    if kind == "lowpass":
        return a1, a2, a3, 0.0 * one, 0.0 * one, one
    if kind == "bell":
        return a1, a2, a3, one, k * (a * a - 1.0), 0.0 * one
    if kind == "lowshelf":
        return a1, a2, a3, one, k * (a - 1.0), a * a - 1.0
    if kind == "highshelf":
        return a1, a2, a3, a * a, k * (1.0 - a) * a, 1.0 - a * a
    raise ValueError(kind)


def sine_approx(x):
    """The LFO's parabolic sine for x in [-pi, pi]."""
    y = (4.0 / math.pi) * x - (4.0 / (math.pi * math.pi)) * x * torch.abs(x)
    return 0.225 * (y * torch.abs(y) - y) + y


def lerp_read(hist, t_read):
    """Linear-interpolated read of ``hist`` [..., H] at fractional indices
    ``t_read`` [..., B] (every index inside the history)."""
    i = torch.floor(t_read)
    f = (t_read - i).to(hist.dtype)
    i = i.to(torch.int64)
    v0 = torch.gather(hist, -1, i)
    v1 = torch.gather(hist, -1, i + 1)
    return v0 + (v1 - v0) * f
