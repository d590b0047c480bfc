"""Stereo chorus with LFO-modulated delay lines and filtered input (port of
``phonic_tpu/effects/chorus.py``).

Behavioural spec: reference src/effect/chorus.rs — two sine-LFO-modulated
interpolated delay lines (right LFO phase-offset by PHASE radians), feedback
written into the line (write = filtered_input + delayed * feedback), an SVF
pre-filter on the input, dry/wet output mix (:311-385).  Modulation range is
256 samples scaled by sample rate (:330-333); read position =
2 + delay + (1 + lfo) * depth_samples.

The input SVF runs as one recurrence over the whole block (it is outside
the feedback loop); the feedback loop is a host loop over sub-blocks whose
body is a fractional window read and a window roll (ops/chrono.py).
Runtime read positions are clamped to >= B+1 samples; construct with a
smaller ``min_delay_ms`` for near-flanger settings.
"""

from __future__ import annotations

import math

import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops import chrono as chrono_ops, filters, lfo as lfo_ops, ring as ring_ops
from ..params import (
    EnumParameter, ExponentialScaling, FloatParameter, format_degrees,
    format_percent,
)

MAX_RANGE_SAMPLES = 256.0  # at 44.1 kHz (chorus.rs:139)
MAX_DELAY_MS = 100.0

RATE = FloatParameter("rate", "Rate", 0.01, 10.0, 1.0, unit="Hz",
                      scaling=ExponentialScaling(2.0))
PHASE = FloatParameter("phas", "Phase", 0.0, math.pi, math.pi / 2.0,
                       formatter=format_degrees)
DEPTH = FloatParameter("dpth", "Depth", 0.0, 1.0, 0.25, formatter=format_percent)
FEEDBACK = FloatParameter("fdbk", "Feedback", -1.0, 1.0, 0.5, formatter=format_percent)
DELAY = FloatParameter("dlay", "Delay", 0.0, MAX_DELAY_MS, 12.0, unit="ms")
WET = FloatParameter("wet_", "Wet", 0.0, 1.0, 0.5, formatter=format_percent)
FILTER_TYPE = EnumParameter("fltt", "Filter Type", ("Lowpass", "Highpass", "Bandpass"), "Lowpass")
FILTER_FREQ = FloatParameter("fltf", "Filter Freq", 20.0, 20000.0, 20000.0,
                             unit="Hz", scaling=ExponentialScaling(2.5))
FILTER_RES = FloatParameter("fltq", "Filter Resonance", 0.0, 1.0, 0.0)


class ChorusEffect(Effect):
    PARAMS = (RATE, PHASE, DEPTH, FEEDBACK, DELAY, WET, FILTER_TYPE,
              FILTER_FREQ, FILTER_RES)
    WEIGHT = 3

    def __init__(self, rate: float = 1.0, phase: float = math.pi / 2.0,
                 depth: float = 0.25, feedback: float = 0.5, delay_ms: float = 12.0,
                 wet: float = 0.5, filter_type: str = "Lowpass",
                 filter_freq: float = 20000.0, filter_resonance: float = 0.0,
                 min_delay_ms: float = None, name=None):
        super().__init__(name)
        self.rate = float(rate)
        self.phase = float(phase)
        self.depth = float(depth)
        self.feedback = float(feedback)
        self.delay_ms = float(delay_ms)
        self.wet = float(wet)
        self.filter_type = filter_type
        self.filter_freq = float(filter_freq)
        self.filter_resonance = float(filter_resonance)
        # smallest modulated read position the program must support
        self.min_delay_ms = float(min_delay_ms if min_delay_ms is not None else delay_ms)

    def param_initials(self):
        return {
            RATE.id: self.rate, PHASE.id: self.phase, DEPTH.id: self.depth,
            FEEDBACK.id: self.feedback, DELAY.id: self.delay_ms, WET.id: self.wet,
            FILTER_TYPE.id: FILTER_TYPE.index_of(self.filter_type),
            FILTER_FREQ.id: self.filter_freq, FILTER_RES.id: self.filter_resonance,
        }

    def _subblock(self, ctx: BuildCtx) -> int:
        min_pos = 2.0 + self.min_delay_ms * ctx.sample_rate / 1000.0
        return ring_ops.pick_subblock(min_pos, ctx.block_frames, cap=512)

    def batch_key(self, ctx: BuildCtx):
        # the sub-block size shapes the feedback loop
        return (type(self).__name__, self._subblock(ctx))

    def _max_offset(self, ctx: BuildCtx) -> int:
        lfo_range = MAX_RANGE_SAMPLES * ctx.sample_rate / 44100.0
        return (2 + int(math.ceil(MAX_DELAY_MS * ctx.sample_rate / 1000.0))
                + 2 * int(math.ceil(lfo_range)) + 2)

    def init_state(self, ctx: BuildCtx):
        dt, dev = ctx.scan_dtype, ctx.device
        return {
            "line": chrono_ops.chrono_init((2,), self._max_offset(ctx),
                                           dtype=dt, device=dev),
            "svf": filters.tpt_state_init((2,), dtype=dt, device=dev),
            "lfo_l": lfo_ops.lfo_init(0.0, device=dev),
            "lfo_r": lfo_ops.lfo_init(0.0, device=dev),  # offset applied per block
        }

    def tail_frames(self, ctx: BuildCtx) -> int:
        """reference: chorus.rs:400-420."""
        sr = ctx.sample_rate
        depth_ms = MAX_RANGE_SAMPLES * 1000.0 / sr
        total_ms = self.delay_ms + depth_ms
        fb = abs(self.feedback)
        if fb >= 1.0:
            return int(10 * sr)
        if fb < 0.001:
            return int(math.ceil(total_ms * sr / 1000.0))
        total = total_ms * sr / 1000.0
        return max(int(math.ceil(total + total * math.log10(0.001) / math.log10(fb))), 1)

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        # FEEDBACK is automatable to +-1.0 -> the "unknown tail" 10 s cap
        return int(10 * ctx.sample_rate)

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("ChorusEffect only supports stereo I/O")
        n = ctx.block_frames
        b = self._subblock(ctx)
        sr = ctx.sample_rate
        lfo_range = MAX_RANGE_SAMPLES * sr / 44100.0
        lanes = torch.arange(x.shape[0], device=x.device)

        # input pre-filter (outside the feedback loop): whole-block recurrence
        ftype = params[FILTER_TYPE.id][:, 0].to(torch.int64)
        cutoff = torch.clamp(params[FILTER_FREQ.id], 20.0, sr / 2.0)
        res = params[FILTER_RES.id]
        g = torch.tan(math.pi * cutoff / sr)
        k = torch.clamp(2.0 * (1.0 - res * 0.97), min=0.03)
        a1 = 1.0 / (1.0 + g * (g + k))
        one = torch.ones_like(g)
        zero = torch.zeros_like(g)
        # output mix per filter type (lowpass, highpass, bandpass), per lane
        m = ((zero, zero, one), (one, -k, -one), (zero, one, zero))
        mix = [torch.stack([t[i] for t in m], dim=1)[lanes, ftype]
               for i in range(3)]
        coefs = filters.TptCoefficients(a1, g * a1, g * g * a1, *mix)
        svf, filtered = filters.tpt_process(state["svf"], x,
                                            filters.per_channel(coefs),
                                            dtype=ctx.scan_dtype)

        # LFOs: sine pair with a phase offset on the right channel
        inc = params[RATE.id] / sr
        phase_norm = params[PHASE.id] / (2.0 * math.pi)
        lfo_l_state, lfo_l = lfo_ops.lfo_block(state["lfo_l"], inc, n)
        # right LFO = left phase + offset, from the same accumulator (both
        # operands are >= 0, so fmod is the floor-mod, exactly)
        shifted = lfo_ops.LfoState(
            phase=torch.fmod(state["lfo_l"].phase + phase_norm[:, 0], 1.0),
            wraps=state["lfo_l"].wraps,
        )
        _, lfo_r = lfo_ops.lfo_block(shifted, inc, n)

        H = chrono_ops.hist_len(self._max_offset(ctx))
        delay_samples = params[DELAY.id] * 0.001 * sr
        depth_samples = lfo_range * params[DEPTH.id]
        pos = torch.stack([
            torch.clamp(2.0 + delay_samples + (1.0 + lfo) * depth_samples,
                        float(b + 1), float(H - 2))
            for lfo in (lfo_l, lfo_r)], dim=1)  # [G, 2, n]
        feedback = torch.clamp(params[FEEDBACK.id], -0.999, 0.999)[:, None, :]

        # feedback loop over sub-blocks (lax.scan in the JAX package): a
        # sub-block shorter than the shortest delay never reads its own
        # writes, so each step reads the window, then rolls its writes in
        win = state["line"].hist
        wets = []
        for t0 in range(0, n, b):
            d = chrono_ops.read_frac_win(win, pos[..., t0:t0 + b])  # [G, 2, B]
            win = chrono_ops.roll(
                win, filtered[..., t0:t0 + b] + d * feedback[..., t0:t0 + b])
            wets.append(d)
        wet = torch.cat(wets, dim=-1).to(x.dtype)

        wet_mix = params[WET.id][:, None, :]
        y = x * (1.0 - wet_mix) + wet * wet_mix
        new_state = {
            "line": chrono_ops.Chrono(win), "svf": svf,
            "lfo_l": lfo_l_state, "lfo_r": state["lfo_r"],
        }
        return new_state, y
