"""5-band parametric EQ: low shelf, 3 bells, high shelf (port of
``phonic_tpu/effects/eq5.py``).

Behavioural spec: reference src/effect/eq5.rs — per-band gain ±20 dB,
exponentially-scaled frequency, bandwidth (linear-smoothed); bells convert
bandwidth to Q via reciprocal (:173-209).  The five bands are cascaded TPT
biquads per channel with per-sample coefficients.

Reference quirk NOT reproduced (as in the JAX package): its non-ramping
path passes the bell bandwidth directly as Q while the ramping path passes
1/bandwidth (eq5.rs:186 vs :208) — 1/bandwidth is used consistently.
"""

from __future__ import annotations

import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops import filters
from ..params import ExponentialScaling, FloatParameter

_DEF_FREQ = (100.0, 1000.0, 4000.0, 8000.0, 12000.0)
_DEF_BW_MAX = (1.0, 4.0, 4.0, 4.0, 1.0)

GAINS = tuple(
    FloatParameter(f"gan{i+1}", f"Gain {i+1}", -20.0, 20.0, 0.0, unit="dB")
    for i in range(5)
)
FREQUENCIES = tuple(
    FloatParameter(
        f"frq{i+1}", f"Frequency {i+1}", 20.0, 20000.0, _DEF_FREQ[i], unit="Hz",
        scaling=ExponentialScaling(2.5),
    )
    for i in range(5)
)
BANDWIDTHS = tuple(
    FloatParameter(
        f"bw_{i+1}", f"Bandwidth {i+1}", 0.0001, _DEF_BW_MAX[i], _DEF_BW_MAX[i],
        smoothing="linear",
    )
    for i in range(5)
)

_BAND_TYPES = (
    filters.LOWSHELF, filters.BELL, filters.BELL, filters.BELL, filters.HIGHSHELF,
)


class Eq5Effect(Effect):
    PARAMS = GAINS + FREQUENCIES + BANDWIDTHS
    WEIGHT = 3

    def __init__(self, gains=None, frequencies=None, bandwidths=None, name=None):
        super().__init__(name)
        self.gains = list(gains or (0.0,) * 5)
        self.frequencies = list(frequencies or _DEF_FREQ)
        self.bandwidths = list(bandwidths or _DEF_BW_MAX)

    def param_initials(self):
        d = {}
        for i in range(5):
            d[GAINS[i].id] = self.gains[i]
            d[FREQUENCIES[i].id] = self.frequencies[i]
            d[BANDWIDTHS[i].id] = self.bandwidths[i]
        return d

    def batch_key(self, ctx: BuildCtx):
        # process() reads no per-instance statics
        return (type(self).__name__,)

    def init_state(self, ctx: BuildCtx):
        return {f"band{i}": filters.tpt_state_init((ctx.channels,),
                                                   device=ctx.device)
                for i in range(5)}

    def process(self, state, x, params, ctx: BuildCtx):
        y = x
        new_state = {}
        for i, ftype in enumerate(_BAND_TYPES):
            freq = torch.clamp(params[FREQUENCIES[i].id], 20.0,
                               ctx.sample_rate / 2.0)
            bw = params[BANDWIDTHS[i].id]
            q = bw if ftype in (filters.LOWSHELF, filters.HIGHSHELF) else (
                1.0 / torch.clamp(bw, min=0.001))
            coefs = filters.biquad_coefficients(
                ftype, ctx.sample_rate, freq, q, params[GAINS[i].id])
            st, y = filters.tpt_process(state[f"band{i}"], y,
                                        filters.per_channel(coefs))
            new_state[f"band{i}"] = st
        return new_state, y
