"""The reference's file sources: looping buffers read at positions that
advance by the speed per output frame, with seeks at block starts."""

from __future__ import annotations

import numpy as np
import torch

from . import dsp

F32 = torch.float32


class FileBank:
    """Every lane's copy of every source as a row (lane-major): ``tables``
    holds each source's float32 samples [ch, frames]; every source loops
    over its whole length."""

    def __init__(self, tables: list, lanes: int, device):
        ch = tables[0].shape[0]
        fmax = max(t.shape[-1] for t in tables)
        table = np.zeros((len(tables), ch, fmax + 3), np.float32)
        for i, t in enumerate(tables):
            table[i, :, :t.shape[-1]] = t
        self.table = torch.as_tensor(table, device=device)
        self.frames = torch.tensor([t.shape[-1] for t in tables] * lanes,
                                   dtype=torch.int32, device=device)
        self.rows = torch.arange(len(tables), device=device).repeat(lanes)
        r = len(tables) * lanes
        self.base = torch.zeros(r, dtype=torch.int32, device=device)
        self.frac = torch.zeros(r, dtype=F32, device=device)
        self.lo = torch.zeros(r, dtype=F32, device=device)
        self.seeks = {}
        self.device = device

    def seek(self, row: int, to_frame: float, block: int = 0):
        """Start ``row``'s ``block``-th next block at source frame
        ``to_frame``."""
        self.seeks[(row, block)] = to_frame

    def positions(self, speed, block: int = None):
        """Read positions [rows, m] for ``speed`` [rows, m] (float32), as
        the engine computes them one block of ``block`` frames (default:
        all of m) at a time."""
        block = block or speed.shape[-1]
        seeks, self.seeks = self.seeks, {}
        out = []
        for k in range(speed.shape[-1] // block):
            self.seeks = {r: v for (r, j), v in seeks.items() if j == k}
            out.append(self._block(speed[:, k * block:(k + 1) * block]))
        return torch.cat(out, -1)

    def _block(self, speed):
        """Each row's float32 read positions [rows, n] for per-sample
        ``speed`` (float32 [rows, n]), as the engine defines them: a seek
        at the block start; ``frac + (s0 * i + residual + lo)`` with s0 the
        block's last step and the residual the exact running sum of (step -
        s0) rounded once; the carry by a compensated float32 sum; every
        loop folded by its source's length."""
        n, dev = speed.shape[-1], self.device
        seek = torch.zeros(len(self.base), dtype=torch.bool, device=dev)
        spos = torch.zeros(len(self.base), dtype=F32, device=dev)
        for row, v in self.seeks.items():
            seek[row] = True
            spos[row] = float(np.float32(v))
        self.seeks = {}
        si = torch.floor(spos)
        base = torch.where(seek, si.to(torch.int32), self.base)
        frac = torch.where(seek, spos - si, self.frac)
        lo = torch.where(seek, torch.zeros_like(self.lo), self.lo)
        s0 = speed[:, -1:]
        resid = torch.cumsum((speed - s0).double(), -1).to(F32)
        rel = s0 * torch.arange(n, dtype=F32, device=dev) + torch.cat(
            [torch.zeros_like(resid[:, :1]), resid[:, :-1]], -1)
        p = frac[:, None] + (rel + lo[:, None])
        ip = torch.floor(p)
        ki = base[:, None] + ip.to(torch.int32)
        pos = torch.remainder(ki, self.frames[:, None]).to(F32) + (p - ip)
        adv = s0[:, 0] * np.float32(n) + resid[:, -1]
        s = frac + adv  # compensated (hi, lo) float32 sum
        bp = s - frac
        e = (frac - (s - bp)) + (adv - bp)
        hi = s + (e + lo)
        lo_new = (e + lo) - (hi - s)
        carry = torch.floor(hi)
        self.base = torch.remainder(base + carry.to(torch.int32), self.frames)
        self.frac, self.lo = hi - carry, lo_new
        return pos

    def read(self, speed, dtype, block: int = None):
        """The next frames of every row: [rows, ch, m] in ``dtype``."""
        return dsp.hermite_read(self.table, self.rows,
                                self.positions(speed, block), dtype)
