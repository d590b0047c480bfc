"""Gain effect with optional DC filtering (port of
``phonic_tpu/effects/gain.py``).

Behavioural spec: reference src/effect/gain.rs — exponentially smoothed
linear gain (displayed -60..+24 dB) plus an optional one-pole DC blocker
(Off / Slow ~1 Hz / Default ~5 Hz / Fast ~20 Hz, :21-46, 143-163).
"""

from __future__ import annotations

import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops import filters
from ..params import DecibelScaling, EnumParameter, FloatParameter, format_gain

GAIN = FloatParameter(
    "GAIN", "Gain", 0.0, 15.848932, 1.0, scaling=DecibelScaling(-60.0, 24.0),
    formatter=format_gain,
)
DC_MODE = EnumParameter("DCFL", "DC Filter", ("Off", "Slow", "Default", "Fast"), "Off")


class GainEffect(Effect):
    PARAMS = (GAIN, DC_MODE)
    WEIGHT = 1

    def __init__(self, gain: float = 1.0, dc_mode: str = "Off", name=None):
        super().__init__(name)
        self.gain = float(gain)
        self.dc_mode = dc_mode

    def param_initials(self):
        return {GAIN.id: self.gain, DC_MODE.id: DC_MODE.index_of(self.dc_mode)}

    def batch_key(self, ctx: BuildCtx):
        # process() reads no per-instance statics
        return (type(self).__name__,)

    def init_state(self, ctx: BuildCtx):
        return {"dc": filters.dc_state_init((ctx.channels,), device=ctx.device)}

    def process(self, state, x, params, ctx: BuildCtx):
        y = x * params[GAIN.id][:, None, :]
        # the DC mode is a stepped enum read at block rate; the filter runs
        # in every mode and is selected per lane, as in the JAX package
        mode = params[DC_MODE.id][:, 0].to(torch.int64)
        rs = torch.tensor(
            [1.0] + [filters.dc_coefficient(ctx.sample_rate, m)
                     for m in ("slow", "default", "fast")],
            dtype=torch.float32, device=x.device)
        r = rs[torch.clamp(mode, 0, 3)]
        dc_state, filtered = filters.dc_process(state["dc"], y, r[:, None, None])
        on = mode > 0
        y = torch.where(on[:, None, None], filtered, y)
        # keep the DC state zeroed while bypassed so enabling it starts clean
        dc_state = filters.DcState(
            y1=torch.where(on[:, None], dc_state.y1, 0.0),
            x1=torch.where(on[:, None], dc_state.x1, 0.0),
        )
        return {"dc": dc_state}, y
