"""Stereo panning effect: phase invert -> mid/side width -> constant-power
pan (port of ``phonic_tpu/effects/pan.py``).

Behavioural spec: reference src/effect/pan.rs (processing order :113-160;
stereo-only).
"""

from __future__ import annotations

import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops.convert import panning_factors
from ..params import BooleanParameter, FloatParameter, format_pan, format_percent

PAN = FloatParameter("pan ", "Pan", -1.0, 1.0, 0.0, formatter=format_pan)
WIDTH = FloatParameter("wdth", "Width", 0.0, 2.0, 1.0, formatter=format_percent)
INVERT_L = BooleanParameter("invl", "Invert L", False)
INVERT_R = BooleanParameter("invr", "Invert R", False)


class PanningEffect(Effect):
    PARAMS = (PAN, WIDTH, INVERT_L, INVERT_R)
    WEIGHT = 1

    def __init__(self, pan: float = 0.0, width: float = 1.0,
                 invert_l: bool = False, invert_r: bool = False, name=None):
        super().__init__(name)
        self.pan = float(pan)
        self.width = float(width)
        self.invert_l = bool(invert_l)
        self.invert_r = bool(invert_r)

    def param_initials(self):
        return {
            PAN.id: self.pan, WIDTH.id: self.width,
            INVERT_L.id: 1.0 if self.invert_l else 0.0,
            INVERT_R.id: 1.0 if self.invert_r else 0.0,
        }

    def batch_key(self, ctx: BuildCtx):
        # process() reads no per-instance statics
        return (type(self).__name__,)

    def process(self, state, x, params, ctx: BuildCtx):
        """x [G, 2, n]; params [G, n]."""
        if ctx.channels != 2:
            raise ValueError("PanningEffect only supports stereo I/O")
        inv_l = torch.where(params[INVERT_L.id] >= 0.5, -1.0, 1.0)
        inv_r = torch.where(params[INVERT_R.id] >= 0.5, -1.0, 1.0)
        left = x[:, 0] * inv_l
        right = x[:, 1] * inv_r
        width = params[WIDTH.id]
        mid = (left + right) * 0.5
        side = (left - right) * 0.5
        apply_w = torch.abs(width - 1.0) > 1e-6
        left = torch.where(apply_w, mid + side * width, left)
        right = torch.where(apply_w, mid - side * width, right)
        pan = params[PAN.id]
        pl, pr = panning_factors(pan)
        apply_p = torch.abs(pan) > 1e-6
        left = torch.where(apply_p, left * pl, left)
        right = torch.where(apply_p, right * pr, right)
        return state, torch.stack([left, right], dim=1)
