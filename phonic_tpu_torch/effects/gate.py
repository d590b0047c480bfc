"""Stereo noise gate with hold and configurable floor (port of
``phonic_tpu/effects/gate.py``).

Behavioural spec: reference src/effect/gate.rs — per-frame stereo peak ->
dB-domain envelope follower -> open/hold/closed state machine -> one-pole
dB-domain gain smoothing with attack/release asymmetry (:147-195); gains
<= -60 dB snap to 0.  Tail: hold + release samples.

The detector (peak -> dB) is elementwise over the block; the per-sample
state (envelope, hold counter, gain dB) is one sequential recurrence per
lane, ``ops/follower.gate_machine`` (kernel 5 on CUDA).
"""

from __future__ import annotations

import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops import follower as follower_ops
from ..ops.envelope import LN10_20, follower_alpha, peak_to_db
from ..params import FloatParameter, format_db

THRESHOLD = FloatParameter("thrs", "Threshold", -60.0, 0.0, -30.0, unit="dB", smoothing=None)
ATTACK = FloatParameter("attk", "Attack", 0.001, 0.5, 0.005, unit="s", smoothing=None)
HOLD = FloatParameter("hold", "Hold", 0.0, 2.0, 0.1, unit="s", smoothing=None)
RELEASE = FloatParameter("rels", "Release", 0.01, 2.0, 0.2, unit="s", smoothing=None)
RANGE = FloatParameter("rnge", "Range", -60.0, 0.0, -60.0, formatter=format_db, smoothing=None)

class GateEffect(Effect):
    PARAMS = (THRESHOLD, ATTACK, HOLD, RELEASE, RANGE)
    WEIGHT = 2

    def __init__(self, threshold: float = -30.0, attack: float = 0.005,
                 hold: float = 0.1, release: float = 0.2, range_db: float = -60.0,
                 name=None):
        super().__init__(name)
        self.threshold = float(threshold)
        self.attack = float(attack)
        self.hold = float(hold)
        self.release = float(release)
        self.range_db = float(range_db)

    def param_initials(self):
        return {
            THRESHOLD.id: self.threshold, ATTACK.id: self.attack,
            HOLD.id: self.hold, RELEASE.id: self.release, RANGE.id: self.range_db,
        }

    def batch_key(self, ctx: BuildCtx):
        # process() reads no per-instance statics
        return (type(self).__name__,)

    def init_state(self, ctx: BuildCtx):
        dt, dev = ctx.scan_dtype, ctx.device
        return {
            "env": torch.tensor(-120.0, dtype=dt, device=dev),
            "hold": torch.tensor(0.0, dtype=dt, device=dev),
            "gain_db": torch.tensor(self.range_db, dtype=dt, device=dev),
        }

    def tail_frames(self, ctx: BuildCtx) -> int:
        return int((self.hold + self.release) * ctx.sample_rate) + 1

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        # HOLD/RELEASE are automatable up to their range maxima
        return int((HOLD.max + RELEASE.max) * ctx.sample_rate) + 1

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("GateEffect only supports stereo I/O")
        sr = ctx.sample_rate
        dt = ctx.scan_dtype
        attack_a = follower_alpha(params[ATTACK.id], sr, dtype=dt)
        release_a = follower_alpha(params[RELEASE.id], sr, dtype=dt)
        hold_samples = torch.floor(params[HOLD.id] * sr).to(dt)
        peak = torch.maximum(torch.abs(x[:, 0]), torch.abs(x[:, 1])).to(dt)

        (env, hold, gain_db), gains_db = follower_ops.gate_machine(
            peak_to_db(peak), attack_a, release_a, params[THRESHOLD.id].to(dt),
            params[RANGE.id].to(dt), hold_samples,
            state["env"], state["hold"], state["gain_db"],
        )
        gain = torch.where(gains_db <= -60.0, 0.0, torch.exp(gains_db / LN10_20))
        gain = torch.where(gains_db == 0.0, 1.0, gain).to(x.dtype)
        y = x * gain[:, None, :]
        return {"env": env, "hold": hold, "gain_db": gain_db}, y
