"""A parameter of every row of a reference render: its smoothing (an
exponential or linear smoother, or stepped with ramp knots) and the events
each row gets in the next block."""

from __future__ import annotations

import numpy as np
import torch

from . import dsp

F32 = torch.float32


class Param:
    """One parameter over all rows: its smoother state and this block's
    events per row."""

    def __init__(self, initial, smoothing: str, rows: int, device, dtype,
                 sr: int = 48000, arg: float = None):
        v = torch.as_tensor(np.asarray(initial, np.float64).reshape(-1),
                            device=device)
        v = v.expand(rows).clone() if v.numel() == 1 else v
        self.smoothing = smoothing
        if smoothing == "step":
            self.cur = v.to(F32)
        else:
            self.cur, self.target = v.to(dtype), v.to(dtype)
        if smoothing == "linear":
            self.step = torch.full_like(self.cur, (arg or dsp.LINEAR_STEP)
                                        * dsp.SMOOTH_REF_SR / sr)
            self.pending = torch.zeros_like(self.cur)
        self.inertia = arg or dsp.DEFAULT_INERTIA
        self.events = [[] for _ in range(rows)]

    def _settled(self, sr: int) -> bool:
        if self.smoothing == "step":
            return True
        if self.smoothing == "linear":
            return bool((self.pending == 0).all())
        ad = dsp.exp_alpha(sr, self.inertia) * torch.abs(
            self.cur - self.target).double()
        return bool((ad <= dsp.SMOOTH_EPS).all())

    def block(self, n: int, sr: int):
        """This block's per-sample values [rows, n]; clears the events."""
        rows = [sorted(e, key=lambda x: x[0]) for e in self.events]
        self.events = [[] for _ in rows]
        if not any(rows) and self._settled(sr):
            # no event and every row at rest: the target throughout
            held = self.cur if self.smoothing == "step" else self.target
            return held[:, None].expand(len(rows), n)
        t, v, r = dsp.event_rows(rows, n, self.cur.device)
        if self.smoothing == "step":
            self.cur, out = dsp.stepped(self.cur, t, v, r, n)
            return out
        if self.smoothing == "exp":
            self.cur, self.target, out = dsp.exp_smooth(
                self.cur, self.target, t, v, n,
                dsp.exp_alpha(sr, self.inertia))
            return out
        (self.cur, self.target, self.step, self.pending,
         out) = dsp.linear_smooth(self.cur, self.target, self.step,
                                  self.pending, t, v, n)
        return out
