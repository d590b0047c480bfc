"""Stereo dub delay with filtered, saturated feedback and LFO modulation
(port of ``phonic_tpu/effects/delay.py``).

Behavioural spec: reference src/effect/delay.rs — modes Stereo / PingPong
(:48-60); spring-smoothed delay time up to 4000 ms; feedback path =
SVF filter -> tanh-approx saturation -> DC blocker -> clamp(+-4)
(:224-248); LFO (7 waveforms) modulating time (+-50 ms), feedback and
filter cutoff (:340-380); equal-power-ish dry/wet law and mid/side stereo
width on the output (:440-452); analytic tail from the feedback factor.

The feedback loop, the only part that reads the fed-back line, is
``ops/delayline.feedback_loop``: one launch of kernel 7 per block on CUDA,
a loop over sub-blocks of B samples on the CPU (B chosen from the smallest
reachable delay, so a sub-block never reads its own writes).  Everything
else (the LFO, the delay times, the SVF coefficients, the output mix) is
vectorised over the block here.  Runtime delay times are clamped to >= B+1
samples; construct with a smaller ``min_delay_ms`` if automation needs
shorter delays, and with a smaller ``max_delay_capacity_ms`` when
automation never exceeds it (it sizes the window).

The LFO's random waveforms use the engine's deterministic counter-seeded
hash (the reference's is OS-seeded and irreproducible).
"""

from __future__ import annotations

import math

import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops import chrono as chrono_ops, filters, lfo as lfo_ops, ring as ring_ops
from ..ops.delayline import feedback_loop, saturate  # noqa: F401
from ..ops.precision import recip32
# format_degrees is a name of this module in the JAX package too
from ..params import (  # noqa: F401
    EnumParameter, ExponentialScaling, FloatParameter, format_degrees,
    format_percent,
)

MAX_DELAY_MS = 4000.0
MAX_LFO_TIME_MOD_MS = 50.0
FILTER_RESONANCE = 0.302  # Q ~= 0.7071 (delay.rs:120)

MODE = EnumParameter("mode", "Mode", ("Stereo", "Ping Pong"), "Stereo")
DELAY_TIME = FloatParameter(
    "dlay", "Delay", 1.0, MAX_DELAY_MS, 375.0, unit="ms",
    smoothing="spring", smoothing_arg=20000.0,
)
FEEDBACK = FloatParameter("fdbk", "Feedback", 0.0, 1.0, 0.5, formatter=format_percent)
FILTER_TYPE = EnumParameter("ftyp", "Filter Type", ("Lowpass", "Highpass", "Bandpass"), "Lowpass")
FILTER_CUTOFF = FloatParameter(
    "cuto", "Filter Cutoff", 20.0, 20000.0, 6000.0, unit="Hz",
    scaling=ExponentialScaling(2.5),
)
DRIVE = FloatParameter("driv", "Drive", 0.0, 1.0, 0.0, formatter=format_percent)
WET = FloatParameter("wet_", "Wet", 0.0, 1.0, 0.5, formatter=format_percent)
WIDTH = FloatParameter("wdth", "Width", 0.0, 1.0, 0.5, formatter=format_percent)
LFO_RATE = FloatParameter(
    "lfor", "LFO Rate", 0.01, 10.0, 1.0, unit="Hz", scaling=ExponentialScaling(2.0)
)
LFO_SHAPE = EnumParameter("lfos", "LFO Shape", lfo_ops.WAVEFORM_NAMES, "Sine")
LFO_TIME = FloatParameter("lfdt", "LFO -> Time", -1.0, 1.0, 0.0, formatter=format_percent)
LFO_FB = FloatParameter("ldfb", "LFO -> Feedback", -1.0, 1.0, 0.0, formatter=format_percent)
LFO_FILTER = FloatParameter("lfdf", "LFO -> Filter", -1.0, 1.0, 0.0, formatter=format_percent)


class DelayEffect(Effect):
    PARAMS = (MODE, DELAY_TIME, FEEDBACK, FILTER_TYPE, FILTER_CUTOFF, DRIVE,
              WET, WIDTH, LFO_RATE, LFO_SHAPE, LFO_TIME, LFO_FB, LFO_FILTER)
    WEIGHT = 3

    def __init__(self, mode: str = "Stereo", delay_ms: float = 375.0,
                 feedback: float = 0.5, filter_type: str = "Lowpass",
                 filter_cutoff: float = 6000.0, drive: float = 0.0,
                 wet: float = 0.5, width: float = 0.5, lfo_rate: float = 1.0,
                 lfo_shape: str = "Sine", lfo_to_time: float = 0.0,
                 lfo_to_feedback: float = 0.0, lfo_to_filter: float = 0.0,
                 min_delay_ms: float = 40.0,
                 max_delay_capacity_ms: float = MAX_DELAY_MS,
                 seed: int = 0x5EED, name=None):
        super().__init__(name)
        self.mode = mode
        self.delay_ms = float(delay_ms)
        self.feedback = float(feedback)
        self.filter_type = filter_type
        self.filter_cutoff = float(filter_cutoff)
        self.drive = float(drive)
        self.wet = float(wet)
        self.width = float(width)
        self.lfo_rate = float(lfo_rate)
        self.lfo_shape = lfo_shape
        self.lfo_to_time = float(lfo_to_time)
        self.lfo_to_feedback = float(lfo_to_feedback)
        self.lfo_to_filter = float(lfo_to_filter)
        self.min_delay_ms = float(min_delay_ms)
        # capacity hint: the window is sized for this many ms and runtime
        # DELAY_TIME automation clamps to it (the default keeps the
        # reference's full 4000 ms range)
        self.max_delay_capacity_ms = float(
            min(max(max_delay_capacity_ms, delay_ms), MAX_DELAY_MS))
        self.seed = seed

    def param_initials(self):
        return {
            MODE.id: MODE.index_of(self.mode), DELAY_TIME.id: self.delay_ms,
            FEEDBACK.id: self.feedback,
            FILTER_TYPE.id: FILTER_TYPE.index_of(self.filter_type),
            FILTER_CUTOFF.id: self.filter_cutoff, DRIVE.id: self.drive,
            WET.id: self.wet, WIDTH.id: self.width, LFO_RATE.id: self.lfo_rate,
            LFO_SHAPE.id: LFO_SHAPE.index_of(self.lfo_shape),
            LFO_TIME.id: self.lfo_to_time, LFO_FB.id: self.lfo_to_feedback,
            LFO_FILTER.id: self.lfo_to_filter,
        }

    def _subblock(self, ctx: BuildCtx) -> int:
        # fewer, larger sub-blocks are cheaper; the only ceiling is the
        # smallest reachable delay (reads stay behind the step's writes)
        min_delay = self.min_delay_ms * ctx.sample_rate / 1000.0
        return ring_ops.pick_subblock(min_delay, ctx.block_frames, cap=8192)

    def batch_key(self, ctx: BuildCtx):
        # sub-block size, window length and the LFO seed are static
        return (type(self).__name__, self._subblock(ctx),
                self._max_offset(ctx), self.seed)

    def _max_offset(self, ctx: BuildCtx) -> int:
        return int(math.ceil(
            (self.max_delay_capacity_ms + MAX_LFO_TIME_MOD_MS)
            * ctx.sample_rate / 1000.0
        )) + 4

    def init_state(self, ctx: BuildCtx):
        dt, dev = ctx.scan_dtype, ctx.device
        return {
            "line": chrono_ops.chrono_init((2,), self._max_offset(ctx),
                                           dtype=dt, device=dev),
            "svf": filters.tpt_state_init((2,), dtype=dt, device=dev),
            "dc": filters.dc_state_init((2,), dtype=dt, device=dev),
            "fb": torch.zeros((2,), dtype=dt, device=dev),
            "lfo": lfo_ops.lfo_init(device=dev),
        }

    def tail_frames(self, ctx: BuildCtx) -> int:
        """Analytic ring-out estimate (reference: delay.rs:455-474)."""
        delay_ms = self.delay_ms + MAX_LFO_TIME_MOD_MS
        delay_samples = delay_ms * ctx.sample_rate / 1000.0
        fb = abs(self.feedback)
        if self.drive > 0.0 or fb >= 0.9999:
            return int(10 * ctx.sample_rate)  # bounded stand-in for "unknown"
        if fb < 0.001:
            return int(math.ceil(delay_samples))
        decay = delay_samples + delay_samples * math.log10(0.001) / math.log10(fb)
        return max(int(math.ceil(decay)), 1)

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        # FEEDBACK can be automated to 1.0 (and DRIVE above 0), which the
        # analytic estimate treats as "unknown" -> the bounded 10 s stand-in
        return int(10 * ctx.sample_rate)

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("DelayEffect only supports stereo I/O")
        n = ctx.block_frames
        b = self._subblock(ctx)
        sr = ctx.sample_rate
        dt = ctx.scan_dtype
        lanes = torch.arange(x.shape[0], device=x.device)

        is_pp = (params[MODE.id][:, 0].to(torch.int64) == 1)[:, None]  # [G, 1]
        ftype = params[FILTER_TYPE.id][:, 0].to(torch.int64)
        shape = params[LFO_SHAPE.id][:, 0].to(torch.int64)

        # LFO over the whole block with per-sample rate
        lfo_state, lfo_val = lfo_ops.lfo_block(
            state["lfo"], params[LFO_RATE.id] * recip32(sr), n, waveform=shape,
            seed=self.seed)

        delay_ms = torch.clamp(
            params[DELAY_TIME.id]
            + lfo_val * params[LFO_TIME.id] * MAX_LFO_TIME_MOD_MS, min=1.0)
        delay_samples = torch.clamp(
            delay_ms * 0.001 * sr, float(b + 1),
            (self.max_delay_capacity_ms + MAX_LFO_TIME_MOD_MS) * 0.001 * sr)

        base_fb = params[FEEDBACK.id]
        feedback = torch.clamp(
            base_fb + lfo_val * params[LFO_FB.id] * (1.0 - torch.abs(base_fb)),
            0.0, 0.999)
        filter_mod = torch.exp2(lfo_val * params[LFO_FILTER.id] * 2.0)
        cutoff = torch.clamp(params[FILTER_CUTOFF.id] * filter_mod, 20.0, sr / 2.0)
        drive = params[DRIVE.id]

        # per-sample SVF coefficients + the output mix by filter type, per lane
        g = torch.tan(math.pi * cutoff / sr)
        k = torch.full_like(g, max(2.0 * (1.0 - FILTER_RESONANCE * 0.97), 0.03))
        a1 = 1.0 / (1.0 + g * (g + k))
        a2 = g * a1
        a3 = g * a2
        one = torch.ones_like(g)
        zero = torch.zeros_like(g)
        m = ((zero, zero, one), (one, -k, -one), (zero, one, zero))
        mix = [torch.stack([t[i] for t in m], dim=1)[lanes, ftype]
               for i in range(3)]
        coefs = filters.per_channel(filters.TptCoefficients(a1, a2, a3, *mix))
        dc_r = filters.dc_coefficient(sr, "default")

        # the feedback loop: the only part that reads the fed-back line
        wet, win, svf, dc, fb_state = feedback_loop(
            x, state["line"].hist, state["svf"], state["dc"], state["fb"],
            delay_samples, feedback, drive, coefs, is_pp, dc_r, b, dt)
        wet = wet.to(x.dtype)

        wet_mix = params[WET.id]
        dry_gain = torch.clamp((1.0 - wet_mix) * 2.0, max=1.0)
        wet_gain = torch.clamp(wet_mix * 2.0, max=1.0)
        out = x * dry_gain[:, None, :] + wet * wet_gain[:, None, :]

        width = params[WIDTH.id]
        mid = (out[:, 0] + out[:, 1]) * 0.5
        side = (out[:, 0] - out[:, 1]) * 0.5
        y = torch.stack([mid + side * width, mid - side * width], dim=1)

        new_state = {"line": chrono_ops.Chrono(win), "svf": svf, "dc": dc,
                     "fb": fb_state, "lfo": lfo_state}
        return new_state, y
