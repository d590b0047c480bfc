"""Stereo reverb (Airwindows-style vibrato'd Householder FDN) (port of
``phonic_tpu/effects/reverb.py``).

Behavioural spec: reference src/effect/reverb.rs — signal path per sample:
predelay -> lowpass biquad A (Q 1.618) -> *wet -> sin() -> 4 cascaded
Schroeder allpasses (g=0.5, prime-ish sizes 43/41/37/31 * size) -> 8
vibrato-modulated feedback delay lines (79..47 * size) cross-coupled in two
Householder-like 4-groups -> mean -> lowpass B (Q 0.618) -> clamp -> asin()
-> lowpass C (Q 0.5) -> + dry.  ROOM_SIZE maps to size = room^2*75+25,
blend/regen/cutoff derive from it (:408-420).

The three lowpasses run as whole-block recurrences; the four allpasses
chain inside one host loop over sub-blocks (w[n] = x[n] - 0.5*w[n-d]); the
8 FDN lines batch into a second loop over sub-blocks.  Every delay line is
a rolling window of its last H samples (newest last): a sub-block shorter
than the smallest reachable delay never reads its own writes, so each step
reads with one gather and appends its writes.  The fractional vibrato read
(the JAX package's 15-way shift-select) is one ``torch.gather`` of the
same values.

Deliberate deviations from the reference (shared with the JAX package):
line delays follow room-size automation at block rate; the denormal-guard
noise injection (reverb.rs:95-103) is dropped; vibrato phases are seeded
deterministically from ``seed`` with numpy, so both packages start from
identical state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..graph.nodes import BuildCtx, Effect
from ..ops import filters
from ..ops import ring as ring_ops
from ..params import FloatParameter, format_percent

ROOM_SIZE = FloatParameter("room", "Room Size", 0.0, 1.0, 0.6,
                           formatter=format_percent, smoothing="linear")
WET = FloatParameter("wet ", "Wet", 0.0, 1.0, 0.35, formatter=format_percent)

# FDN line delay factors * size, and per-line vibrato depths (reverb.rs:105-151)
_LINE_FACTORS = np.array([79.0, 73.0, 71.0, 67.0, 61.0, 59.0, 53.0, 47.0])
_VIB_DEPTHS = np.array([0.003251, 0.002999, 0.002917, 0.002749,
                        0.002503, 0.002423, 0.002146, 0.002088])
_AP_FACTORS = np.array([43.0, 41.0, 37.0, 31.0])
_PRE_FACTOR = 29.0
VIB_SPEED = 0.1
VIB_DEPTH = 7.0


class ReverbEffect(Effect):
    PARAMS = (ROOM_SIZE, WET)
    WEIGHT = 5

    def __init__(self, room_size: float = 0.6, wet: float = 0.35,
                 seed: int = 0xA1B2, max_room_size: float = 1.0,
                 min_room_size: float = 0.0, name=None):
        super().__init__(name)
        self.room_size = float(room_size)
        self.wet = float(wet)
        self.seed = seed
        self._resets: list[int] = []
        # capacity hint: delay storage is sized for the largest ROOM_SIZE
        # this instance will ever be automated to; the room is clamped to it
        if not (0.0 < max_room_size <= 1.0):
            raise ValueError(f"max_room_size out of (0, 1]: {max_room_size}")
        if float(room_size) > float(max_room_size):
            raise ValueError("room_size exceeds max_room_size capacity")
        self.max_room_size = float(max_room_size)
        # floor hint: promising ROOM_SIZE never goes below this raises the
        # minimum reachable delay, allowing fewer, larger sub-blocks
        if not (0.0 <= min_room_size <= float(room_size)):
            raise ValueError("min_room_size must be in [0, room_size]")
        self.min_room_size = float(min_room_size)
        size_cap = self.max_room_size ** 2 * 75.0 + 25.0
        self._line_buf = 1 << int(79.0 * size_cap + 1).bit_length()
        self._ap_buf = 1 << int(43.0 * size_cap + 1).bit_length()
        self._pre_max = int(_PRE_FACTOR * size_cap) + 2

    def reset(self, time: int = 0):
        """Flush all delay lines at block granularity
        (reference: ReverbEffectMessage::Reset, reverb.rs:470-494)."""
        self._resets.append(int(time))

    def lower_block_inputs(self, block_start: int, block_len: int):
        hit = any(block_start <= t < block_start + block_len
                  for t in self._resets)
        # prune consumed resets so a past reset never re-fires
        self._resets = [t for t in self._resets if t >= block_start + block_len]
        return {"_reset": np.float32(1.0 if hit else 0.0)}

    def param_initials(self):
        return {ROOM_SIZE.id: self.room_size, WET.id: self.wet}

    def batch_key(self, ctx: BuildCtx):
        # instances with equal buffer capacities and sub-blocks run the same
        # code and can share one batched run
        return (type(self).__name__, self._line_buf, self._ap_buf,
                self._pre_max, self._subblocks(ctx))

    def init_state(self, ctx: BuildCtx):
        rng = np.random.default_rng(self.seed)
        dt, dev = ctx.scan_dtype, ctx.device
        vib_phase = rng.uniform(0.0, 2.0 * math.pi, size=(8, 2)).astype(
            np.float32)

        def zeros(*shape):
            return torch.zeros(shape, dtype=dt, device=dev)

        return {
            "pre": zeros(2, self._pre_max),
            "bq_a": filters.tpt_state_init((2,), dtype=dt, device=dev),
            "bq_b": filters.tpt_state_init((2,), dtype=dt, device=dev),
            "bq_c": filters.tpt_state_init((2,), dtype=dt, device=dev),
            "ap_buf": zeros(4, 2, self._ap_buf),
            "line_buf": zeros(8, 2, self._line_buf),
            "vib_phase": torch.as_tensor(vib_phase, device=dev).to(dt),
            "fb": zeros(8, 2),
        }

    def _subblocks(self, ctx: BuildCtx):
        # smallest reachable size (room >= min_room_size; room 0 -> 25):
        # min allpass delay 31*size, min line delay 47*size with <=15
        # samples of vibrato margin
        size_min = self.min_room_size ** 2 * 75.0 + 25.0
        b_ap = ring_ops.pick_subblock(31 * size_min, ctx.block_frames,
                                      cap=2048)
        b_fdn = ring_ops.pick_subblock(47 * size_min - 18, ctx.block_frames,
                                       cap=4096)
        return b_ap, b_fdn

    def process(self, state, x, params, ctx: BuildCtx):
        if ctx.channels != 2:
            raise ValueError("ReverbEffect only supports stereo I/O")
        n = ctx.block_frames
        sr = ctx.sample_rate
        b_ap, b_fdn = self._subblocks(ctx)
        dt = ctx.scan_dtype
        dev = x.device
        lanes = x.shape[0]

        # scheduled Reset (a host-lowered flag per lane): zero the delay
        # lines and filter states at block start; vibrato phases keep their
        # seeds, like the reference's reset which only flushes buffers
        reset = np.asarray(params.get("_reset", np.zeros(lanes))) > 0.5
        if reset.any():
            keep = torch.as_tensor(~reset, device=dev)

            def flush(a):
                return a * keep.view((lanes,) + (1,) * (a.dim() - 1)).to(a.dtype)

            state = {k: v if k == "vib_phase" else (
                type(v)(*map(flush, v)) if isinstance(v, tuple) else flush(v))
                for k, v in state.items()}

        room = params[ROOM_SIZE.id]  # [G, n] linear-smoothed
        if self.max_room_size < 1.0:
            room = torch.clamp(room, max=np.float32(self.max_room_size))
        if self.min_room_size > 0.0:
            room = torch.clamp(room, min=np.float32(self.min_room_size))
        wet = params[WET.id]  # [G, n] exp-smoothed
        # derived controls (reverb.rs:408-420); sizes at block rate
        room0 = room[:, 0]
        size_arr = room * room * 75.0 + 25.0
        size0 = room0 * room0 * 75.0 + 25.0
        cutoff = torch.clamp(10000.0 - room * wet * 3000.0, 20.0, sr / 2.0)
        depth_factor = 1.0 - (1.0 - (0.82 - ((1.0 - room) * 0.7 + size_arr * 0.002))) ** 4
        blend = 0.955 - size_arr * 0.007
        regen = depth_factor * 0.5

        def factors(f):
            return torch.as_tensor(np.asarray(f, np.float32), device=dev)

        line_delay = (factors(_LINE_FACTORS) * size0[:, None]).to(torch.int64)
        ap_delay = (factors(_AP_FACTORS) * size0[:, None]).to(torch.int64)
        predelay = (factors(_PRE_FACTOR) * size0).to(torch.int64)

        # ---- predelay (write-then-read integer delay) + biquad A + sin -----
        pre_big = torch.cat([state["pre"], x.to(dt)], dim=-1)
        start = self._pre_max - predelay  # [G]
        idx = start[:, None, None] + torch.arange(n, device=dev)
        delayed_in = torch.gather(pre_big, -1, idx.expand(lanes, 2, n))
        pre = pre_big[..., n:]

        coefs_a = filters.biquad_coefficients(filters.LOWPASS, sr, cutoff, 1.618034)
        bq_a, filt_a = filters.tpt_process(
            state["bq_a"], delayed_in, filters.per_channel(coefs_a), dtype=dt)
        drive_in = torch.sin(filt_a * wet[:, None, :])

        # ---- 4 cascaded allpasses in one loop over sub-blocks --------------
        # Within a sub-block (< min allpass delay), stage a+1's sample j
        # depends only on stage a's sample j and its own older history, so
        # all four stages chain inside one step.  Window index of an
        # absolute delay d is H - d; one gather reads all four stages.
        h_ap = self._ap_buf
        ap_idx = ((h_ap - ap_delay)[:, :, None, None]
                  + torch.arange(b_ap, device=dev)).expand(lanes, 4, 2, b_ap)
        buf4 = state["ap_buf"]  # [G, 4, 2, H]
        outs = []
        for t0 in range(0, n, b_ap):
            sig = drive_in[..., t0:t0 + b_ap].to(dt)
            delayed = torch.gather(buf4, -1, ap_idx)  # [G, 4, 2, B]
            writes, stage_outs = [], []
            for a in range(4):
                w = sig - delayed[:, a] * 0.5
                sig = w * 0.5 + delayed[:, a]
                writes.append(w)
                stage_outs.append(sig)
            buf4 = torch.cat([buf4[..., b_ap:], torch.stack(writes, dim=1)],
                             dim=-1)
            outs.append(torch.stack(stage_outs, dim=1))
        stages = torch.cat(outs, dim=-1)  # [G, 4, 2, n]
        ap_i, ap_j, ap_k, ap_l = stages.unbind(1)

        # FDN line inputs (reverb.rs:275-283): a/h <- allpass L, b/g <- K,
        # c/f <- J, d/e <- I
        line_in = torch.stack([ap_l, ap_k, ap_j, ap_i, ap_i, ap_j, ap_k, ap_l],
                              dim=1)  # [G, 8, 2, n]

        # ---- 8-line vibrato FDN in one loop over sub-blocks ----------------
        # The read for output sample t is buf[t - delay + floor(offset)] with
        # the fraction interpolating one sample newer; offset = (sin+1)*7
        # lies in [0, 14].  Reads happen after the reference's step()
        # (reverb.rs:284-301, 554-586): the vibrato phase is advanced once.
        vib_inc = torch.as_tensor(_VIB_DEPTHS * VIB_SPEED, device=dev).to(dt)
        vib_inc3 = vib_inc[:, None, None]
        h_ln = self._line_buf
        base_idx = (h_ln - line_delay)[:, :, None, None]  # [G, 8, 1, 1]
        j = torch.arange(b_fdn, device=dev)
        vib_base = state["vib_phase"][..., None]  # phase at block start
        buf, fb = state["line_buf"], state["fb"]  # [G, 8, 2, H], [G, 8, 2]
        wet_parts = []
        for t0 in range(0, n, b_fdn):
            vib = vib_base + vib_inc3 * (t0 + j).to(dt)  # [G, 8, 2, B]
            # floor(offset) picks the tap, so the read jumps where the
            # offset crosses an integer.  A float32 sine differs by an ulp
            # or two between CPU and CUDA libraries, enough to pick another
            # tap now and then; a float64 sine rounded to float32 is the
            # same on both but with a vanishing probability, so CPU and
            # CUDA renders pick the same taps
            vib_sin = torch.sin((vib + vib_inc3).double()).to(dt)
            offset = (vib_sin + 1.0) * VIB_DEPTH
            off_floor = torch.floor(offset)
            w_frac = offset - off_floor
            gidx = base_idx + j + off_floor.to(torch.int64)
            v1 = torch.gather(buf, -1, gidx)
            v2 = torch.gather(buf, -1, gidx + 1)
            bl = blend[:, None, None, t0:t0 + b_fdn]
            interp = (1.0 - bl) * (v1 * (1.0 - w_frac) + v2 * w_frac) + v1 * bl

            # cross-line feedback (Householder 4-groups), 1-sample lag
            rg = regen[:, None, None, t0:t0 + b_fdn]
            g1 = torch.sum(interp[:, :4], dim=1, keepdim=True)
            g2 = torch.sum(interp[:, 4:], dim=1, keepdim=True)
            gsum = torch.cat([g1.expand(-1, 4, -1, -1),
                              g2.expand(-1, 4, -1, -1)], dim=1)
            fb_now = (2.0 * interp - gsum) * rg  # [G, 8, 2, B]
            fb_prev = torch.cat([fb[..., None], fb_now[..., :-1]], dim=-1)
            writes = (line_in[..., t0:t0 + b_fdn] + fb_prev).to(dt)
            buf = torch.cat([buf[..., b_fdn:], writes], dim=-1)
            fb = fb_now[..., -1]
            wet_parts.append(torch.mean(interp, dim=1))  # [G, 2, B]
        wet_sig = torch.cat(wet_parts, dim=-1)
        # the vibrato phase advances by inc per sample across the block;
        # wrapped to [0, 2pi) (both operands >= 0, so fmod is the floor-mod)
        vib_phase = torch.fmod(
            state["vib_phase"] + vib_inc[:, None] * n,
            torch.tensor(2.0 * math.pi, dtype=dt, device=dev))

        # ---- output chain: biquad B -> clamp -> asin -> biquad C -> + dry --
        coefs_b = filters.biquad_coefficients(filters.LOWPASS, sr, cutoff, 0.618034)
        bq_b, filt_b = filters.tpt_process(
            state["bq_b"], wet_sig, filters.per_channel(coefs_b), dtype=dt)
        shaped = torch.asin(torch.clamp(filt_b, -1.0, 1.0))
        coefs_c = filters.biquad_coefficients(filters.LOWPASS, sr, cutoff, 0.5)
        bq_c, filt_c = filters.tpt_process(
            state["bq_c"], shaped, filters.per_channel(coefs_c), dtype=dt)
        y = (filt_c + x * (1.0 - wet)[:, None, :]).to(x.dtype)

        new_state = {
            "pre": pre, "bq_a": bq_a, "bq_b": bq_b, "bq_c": bq_c,
            "ap_buf": buf4, "line_buf": buf, "vib_phase": vib_phase, "fb": fb,
        }
        return new_state, y
