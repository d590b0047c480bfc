"""Plain PyTorch envelope followers whose attack or release coefficient is
chosen by comparing the input with the running envelope.

Such a recurrence branches on its own state, so it is no associative scan;
here it is solved as a fixed point: guess which samples attack, solve the
then linear recurrence ``e[t] = e[t-1] + a[t] (x[t] - e[t-1])`` by recursive
doubling, re-decide each sample from the envelope before it, and repeat
until no decision changes.  The decisions that agree with their own
envelope are unique (sample t's depends only on samples before it), and
each pass fixes at least the first wrong one, so the fixed point is the
sequential answer.
"""

from __future__ import annotations

import torch

MAX_PASSES = 400


def affine1_scan(a, b, y0):
    """``y[t] = a[t] y[t-1] + b[t]`` along the last axis from ``y0``, by
    recursive doubling."""
    n = b.shape[-1]
    a, b = torch.broadcast_tensors(a, b)
    a, b = a.clone(), b.clone()
    d = 1
    while d < n:
        na = a[..., d:] * a[..., :-d]
        nb = a[..., d:] * b[..., :-d] + b[..., d:]
        a = torch.cat([a[..., :d], na], -1)
        b = torch.cat([b[..., :d], nb], -1)
        d *= 2
    return a * y0[..., None] + b


def follow(x, attack, release, e0):
    """The envelope ``e[t] = e[t-1] + c[t] (x[t] - e[t-1])`` with ``c`` the
    attack coefficient where ``x[t] > e[t-1]`` and the release one elsewhere
    (x, attack, release [R, n]; e0 [R]).  Returns the envelope [R, n]."""
    up = x > e0[:, None]  # the first guess: every sample against e0
    # solved for the distance u = e - x, which a constant input keeps
    # exactly at 0 once the envelope has reached it (a gate that starts
    # closed stays at exactly its range)
    xp = torch.cat([e0[:, None], x[:, :-1]], -1)
    for _ in range(MAX_PASSES):
        k = 1.0 - torch.where(up, attack, release)
        e = x + affine1_scan(k, k * (xp - x), torch.zeros_like(e0))
        prev = torch.cat([e0[:, None], e[:, :-1]], -1)
        now = x > prev
        if torch.equal(now, up):
            return e
        up = now
    raise RuntimeError("the follower's decisions did not settle")
