"""Multi-channel biquad filter effect, LP / BP / notch / HP (port of
``phonic_tpu/effects/filter.py``).

Behavioural spec: reference src/effect/filter.rs — TPT biquad with
exponentially-scaled cutoff (20 Hz..20 kHz, x^2.5), linearly-smoothed Q, and
per-frame coefficient recomputation while parameters ramp (:160-196).
Ramped parameters are per-sample coefficient tensors feeding the same
recurrence (ops/filters.tpt_process: the iir2 kernel on the card), one call
for every lane and channel.  Tail: sample_rate / 10 (:199-204).
"""

from __future__ import annotations

import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops import filters
from ..params import EnumParameter, ExponentialScaling, FloatParameter

FILTER_TYPE = EnumParameter(
    "type", "Type", ("Lowpass", "Bandpass", "Bandstop", "Highpass"), "Lowpass"
)
CUTOFF = FloatParameter(
    "cuto", "Cutoff", 20.0, 20000.0, 20000.0, unit="Hz",
    scaling=ExponentialScaling(2.5),
)
Q = FloatParameter("fltq", "Resonance", 0.001, 4.0, 0.707, smoothing="linear")


class FilterEffect(Effect):
    PARAMS = (FILTER_TYPE, CUTOFF, Q)
    WEIGHT = 2

    def __init__(self, filter_type: str = "Lowpass", cutoff: float = 20000.0,
                 q: float = 0.707, name=None):
        super().__init__(name)
        self.filter_type = filter_type
        self.cutoff = float(cutoff)
        self.q = float(q)

    def param_initials(self):
        return {
            FILTER_TYPE.id: FILTER_TYPE.index_of(self.filter_type),
            CUTOFF.id: self.cutoff,
            Q.id: self.q,
        }

    def batch_key(self, ctx: BuildCtx):
        # process() reads no per-instance statics
        return (type(self).__name__,)

    def init_state(self, ctx: BuildCtx):
        return {"tpt": filters.tpt_state_init((ctx.channels,),
                                              device=ctx.device)}

    def tail_frames(self, ctx: BuildCtx) -> int:
        return ctx.sample_rate // 10

    def process(self, state, x, params, ctx: BuildCtx):
        cutoff = torch.clamp(params[CUTOFF.id], 20.0, ctx.sample_rate / 2.0)
        q = params[Q.id]
        # the integrator core (a1..a3) is the same for the four types; only
        # the output mix m0..m2 follows the stepped type, read at block rate
        # per lane and selected on the device (no host read of its value)
        base = filters.biquad_coefficients(filters.LOWPASS, ctx.sample_rate,
                                           cutoff, q)
        k = 1.0 / q
        t = torch.clamp(params[FILTER_TYPE.id][:, :1].to(torch.int64), 0, 3)
        # Lowpass (0, 0, 1), Bandpass (0, 1, 0), Bandstop (1, -k, 0),
        # Highpass (1, -k, -1)
        m0 = (t >= 2).to(torch.float32).expand_as(k)
        m1 = torch.where(t == 1, 1.0, torch.where(t >= 2, -k, 0.0))
        m2 = torch.where(t == 0, 1.0, torch.where(t == 3, -1.0, 0.0)
                         ).expand_as(k)
        coefs = filters.TptCoefficients(base.a1, base.a2, base.a3, m0, m1, m2)
        new_tpt, y = filters.tpt_process(state["tpt"], x,
                                         filters.per_channel(coefs))
        return {"tpt": new_tpt}, y
