"""Stereo compressor / limiter with lookahead and soft knee (port of
``phonic_tpu/effects/compressor.py``).

Behavioural spec: reference src/effect/compressor.rs — ratio >= 20 switches
to limiter mode (slope 1, detector = peak over the whole lookahead window,
:239-260); soft-knee quadratic gain curve (:262-281); dB-domain
attack/release envelope follower; exponentially-smoothed makeup gain;
output = lookahead-delayed signal * gain.  Tail: lookahead + release.

The lookahead delay is a static shift (a carried [G, 2, D] tail); the
limiter's detector is the exact sliding-window maximum over the window;
only the envelope follower is sequential (``ops/follower.asym_follower``,
kernel 4 on CUDA).  The lookahead time is static per program (the
reference reallocates its delay line on change too, compressor.rs:318-320).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..graph.nodes import BuildCtx, Effect
from ..ops import follower as follower_ops
from ..ops.envelope import LN10_20, follower_alpha, peak_to_db
# format_db is a name of this module in the JAX package too
from ..params import FloatParameter, format_db, format_ratio  # noqa: F401

THRESHOLD = FloatParameter("thrs", "Threshold", -60.0, 0.0, -12.0, unit="dB", smoothing=None)
RATIO = FloatParameter("rato", "Ratio", 1.0, 20.0, 8.0, formatter=format_ratio, smoothing=None)
KNEE = FloatParameter("knee", "Knee", 0.0, 12.0, 3.0, smoothing=None)
ATTACK = FloatParameter("attk", "Attack", 0.001, 0.5, 0.02, unit="s", smoothing=None)
RELEASE = FloatParameter("rels", "Release", 0.1, 2.0, 2.0, unit="s", smoothing=None)
MAKEUP = FloatParameter("gain", "Makeup Gain", -24.0, 24.0, 6.0, unit="dB")
LOOKAHEAD = FloatParameter("look", "Lookahead", 0.001, 0.2, 0.04, unit="s", smoothing=None)

DEFAULT_LIMITER_THRESHOLD = -0.01


def sliding_window_max(x: torch.Tensor, w: int) -> torch.Tensor:
    """Exact sliding-window maximum along the last axis (van Herk /
    Gil-Werman: a forward and a backward running maximum per chunk of w).

    Returns y with y[..., k] = max(x[..., k:k+w]) for k in [0, L - w]."""
    n = x.shape[-1]
    n_out = n - w + 1
    xp = F.pad(x, (0, (-n) % w), value=-math.inf)
    chunks = xp.reshape(x.shape[:-1] + (-1, w))
    prefix = torch.cummax(chunks, dim=-1).values.flatten(-2)
    suffix = torch.cummax(chunks.flip(-1), dim=-1).values.flip(-1).flatten(-2)
    # window [k, k+w-1] spans at most two chunks: the suffix covers k to its
    # chunk's end, the prefix the next chunk's start to k+w-1
    return torch.maximum(suffix[..., :n_out], prefix[..., w - 1:w - 1 + n_out])


class CompressorEffect(Effect):
    PARAMS = (THRESHOLD, RATIO, KNEE, ATTACK, RELEASE, MAKEUP, LOOKAHEAD)
    WEIGHT = 4

    def __init__(self, threshold: float = -12.0, ratio: float = 8.0,
                 knee: float = 3.0, attack: float = 0.02, release: float = 2.0,
                 makeup_gain: float = 6.0, lookahead: float = 0.04, name=None):
        super().__init__(name)
        self.threshold = float(threshold)
        self.ratio = float(ratio)
        self.knee = float(knee)
        self.attack = float(attack)
        self.release = float(release)
        self.makeup_gain = float(makeup_gain)
        self.lookahead = float(lookahead)

    @classmethod
    def limiter(cls, threshold: float = DEFAULT_LIMITER_THRESHOLD,
                attack: float = 0.02, release: float = 2.0, name=None):
        """Limiter preset: ratio 20, hard knee, no makeup, lookahead = attack
        (reference: compressor.rs:112-156)."""
        return cls(threshold=threshold, ratio=20.0, knee=0.0, attack=attack,
                   release=release, makeup_gain=0.0, lookahead=attack, name=name)

    def param_initials(self):
        return {
            THRESHOLD.id: self.threshold, RATIO.id: self.ratio, KNEE.id: self.knee,
            ATTACK.id: self.attack, RELEASE.id: self.release,
            MAKEUP.id: self.makeup_gain, LOOKAHEAD.id: self.lookahead,
        }

    def _delay_frames(self, ctx: BuildCtx) -> int:
        return int(math.ceil(self.lookahead * ctx.sample_rate))

    def batch_key(self, ctx: BuildCtx):
        # the lookahead sets the delay-line length
        return (type(self).__name__, self._delay_frames(ctx))

    def init_state(self, ctx: BuildCtx):
        dev = ctx.device
        return {
            # the last D input frames (the lookahead delay line)
            "tail": torch.zeros((ctx.channels, self._delay_frames(ctx)),
                                dtype=torch.float32, device=dev),
            "env": torch.tensor(-120.0 if self.ratio >= 20.0 else 0.0,
                                dtype=ctx.scan_dtype, device=dev),
        }

    def tail_frames(self, ctx: BuildCtx) -> int:
        return self._delay_frames(ctx) + int(math.ceil(self.release * ctx.sample_rate))

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        # RELEASE is automatable up to its range max (the lookahead delay
        # line length is fixed at construction)
        return self._delay_frames(ctx) + int(math.ceil(RELEASE.max * ctx.sample_rate))

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("CompressorEffect only supports stereo I/O")
        n = ctx.block_frames
        d = self._delay_frames(ctx)
        sr = ctx.sample_rate
        dt = ctx.scan_dtype

        ratio = params[RATIO.id]
        attack_a = follower_alpha(params[ATTACK.id], sr, dtype=dt)
        release_a = follower_alpha(params[RELEASE.id], sr, dtype=dt)

        ext = torch.cat([state["tail"].to(x.dtype), x], dim=-1)  # [G, 2, D + n]
        # delayed[i] = input[i - d] (the tail holds the previous D frames)
        delayed = ext[..., :n] if d > 0 else x
        frame_peak = torch.maximum(torch.abs(x[:, 0]), torch.abs(x[:, 1]))
        if d > 0:
            # limiter detector: the peak over the last D frames incl. this one
            ext_peak = torch.maximum(torch.abs(ext[:, 0]), torch.abs(ext[:, 1]))
            lookahead_peak = sliding_window_max(ext_peak, d)[:, -n:]
        else:
            lookahead_peak = frame_peak
        is_limiter = ratio >= 20.0
        input_db = peak_to_db(torch.where(is_limiter, lookahead_peak,
                                          frame_peak).to(dt))

        env_end, envelope = follower_ops.asym_follower(
            input_db, attack_a, release_a, state["env"])

        slope = torch.where(is_limiter, 1.0,
                            1.0 - 1.0 / torch.clamp(ratio, min=1.0))
        t = params[THRESHOLD.id]
        w = params[KNEE.id]
        lower = t - w / 2.0
        upper = t + w / 2.0
        xk = (envelope - lower) / torch.clamp(w, min=1e-9)
        in_knee = (w > 0.0) & (envelope > lower) & (envelope < upper)
        gr_db = torch.where(
            in_knee, xk * xk * slope * w / 2.0,
            torch.where(envelope > upper, (envelope - t) * slope, 0.0))

        total_db = params[MAKEUP.id] - gr_db
        gain = torch.where(total_db == 0.0, 1.0,
                           torch.exp(total_db / LN10_20)).to(x.dtype)
        y = delayed * gain[:, None, :]
        new_tail = ext[..., -d:].clone() if d > 0 else state["tail"]
        return {"tail": new_tail, "env": env_end}, y
