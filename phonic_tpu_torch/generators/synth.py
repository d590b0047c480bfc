"""Polyphonic synth generator from a SynthDef (port of
``phonic_tpu/generators/synth.py``, the FunDspGenerator analog).

Behavioural spec: reference src/generator/fundsp.rs — a voice-factory
closure produces per-voice FunDSP graphs driven by (gate, freq, volume,
pan) shared vars; note events allocate voices with the sampler's steal
policy; frequency glides morph exponentially between notes
(src/generator/fundsp/voice.rs:312-346, GlideState :538-560).

The same host-side allocator as the Sampler lowers notes to per-voice
descriptors (one continuing note plus at most one retrigger per voice and
block).  ``render_lanes`` evaluates every voice's note logic over ``[V, n]``
and renders all V voices in ONE call of the batched SynthDef
(sources/synth.py), so sub3's filter is one iir2 launch of V rows.  Glides
are exact exponential-in-pitch trajectories computed from the note ages.

Deliberate difference: the JAX package's generator has no ``envelope``
attribute, so a voice steal there raises AttributeError inside the
borrowed allocator; here ``envelope = None`` makes a steal take the oldest
voice, as the sampler without an envelope does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..graph.nodes import BuildCtx
from ..modulation.matrix import (
    ModulationRoutings, apply_matrix, build_source_specs, eval_sources,
    source_polarity,
)
from ..ops.convert import panning_factors
from ..ops.precision import recip32
from ..ops.smoothing import SegmentEvents, step_targets
from ..params import DecibelScaling, FloatParameter, format_gain, format_pan
from ..sources.synth import SynthContext, SynthDef
from .base import Generator, GeneratorPlaybackOptions
from .sampler import Sampler, voice_rows

# no scheduled stop (the JAX package's name here, as in sources/file.py)
NEVER = np.iinfo(np.int32).max

VOLUME = FloatParameter("SVOL", "Volume", 1e-6, 15.848932, 1.0,
                        scaling=DecibelScaling(-60.0, 24.0), formatter=format_gain)
PANNING = FloatParameter("SPAN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)

# a synth voice's modulation seed: _SEED ^ (0x9E37 * (voice index + 1))
_SEED = 0x7157


def _exp2_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``exp2`` as float64 rounded once, identical on the card and
    on the CPU (their float32 ``exp2`` may differ by an ulp)."""
    return torch.exp2(x.to(torch.float64)).to(torch.float32)


def note_to_hz(note):
    note = torch.as_tensor(note, dtype=torch.float32)
    return 440.0 * _exp2_f32((note - 69.0) * recip32(12.0))


def note_speed(note: torch.Tensor) -> torch.Tensor:
    """2^((note - 60) / 12) evaluated in float64 and rounded once: the same
    float32 as the host's ``_Segment.speed0()`` lowers for a note, so an
    unautomated voice's frequency multiplier is exactly 1."""
    return torch.exp2((note.to(torch.float64) - 60.0) / 12.0).to(torch.float32)


class SynthGenerator(Generator):
    """Polyphonic note-driven synth built from a SynthDef."""

    PARAMS = (VOLUME, PANNING)
    BATCH_CARRY = ("synth",)
    envelope = None  # the borrowed allocator's steal policy reads it

    def __init__(self, synth: SynthDef,
                 options: Optional[GeneratorPlaybackOptions] = None,
                 release_secs: float = 0.2, glide_secs: float = 0.0, name=None):
        super().__init__(options, name)
        self.synth = synth
        self.release_secs = float(release_secs)  # voice considered free after
        self.glide_secs = float(glide_secs)
        self.granular = None  # allocator shim (shared with Sampler)
        self._plan_cache = None
        # user-declared FourCC parameters (reference: fundsp Shared vars,
        # src/generator/fundsp.rs:88-99 + fundsp/parameter.rs:1-123)
        self.PARAMS = SynthGenerator.PARAMS + tuple(synth.params)
        self.mod_config = None
        self.modulation = None

    def with_modulation(self, config) -> "SynthGenerator":
        """Install a ModulationConfig whose targets are this synth's user
        parameter ids: per-voice matrix outputs arrive as
        ``SynthContext.mods[target_id]`` ``[V, n]`` for the SynthDef to
        combine (reference: src/generator/fundsp/modulation.rs:159-220)."""
        valid = {p.id for p in self.synth.params}
        bad = [t for t in config.targets if t not in valid]
        if bad:
            raise ValueError(
                f"modulation targets {bad} are not user parameters of this "
                f"synth (have {sorted(valid)})")
        self.mod_config = config
        self.modulation = ModulationRoutings(config)
        have = {p.id for p in self.PARAMS}
        self.PARAMS = self.PARAMS + tuple(
            p for p in config.source_parameters() if p.id not in have)
        return self

    def set_modulation(self, source: str, target: str, amount: float,
                       bipolar: bool = True):
        if self.modulation is None:
            raise ValueError("no ModulationConfig installed; call "
                             "with_modulation() first")
        self.modulation.set(source, target, amount, bipolar)

    def clear_modulation(self, source: str, target: str):
        if self.modulation is not None:
            self.modulation.clear(source, target)

    @property
    def WEIGHT(self):
        return max(2, self.options.voices // 2)

    def param_initials(self):
        out = {VOLUME.id: self.options.volume, PANNING.id: self.options.panning}
        for p in self.synth.params:
            out[p.id] = p.default
        return out

    # voice allocation: reuse the Sampler's host allocator with a fixed
    # release duration (and its prepare(): lowering needs the output rate)
    _allocate = Sampler._allocate
    prepare = Sampler.prepare

    def lower_block_inputs(self, block_start: int, block_len: int):
        out = Sampler.lower_block_inputs(self, block_start, block_len)
        if self.modulation is not None:
            out["_mod_amt"] = self.modulation.amounts.copy()
            out["_mod_bip"] = self.modulation.bipolar.copy()
        return out

    def _voice_end(self, seg, ctx_sr: int) -> float:
        if seg.release is math.inf:
            return math.inf
        return min(seg.release + self.release_secs * ctx_sr + 1, seg.cut)

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        voices = self._allocate(ctx.sample_rate)
        total = 0
        for segs in voices:
            for seg in segs:
                end = self._voice_end(seg, ctx.sample_rate)
                if end is math.inf:
                    return None
                total = max(total, int(end))
        return total

    def init_state(self, ctx: BuildCtx):
        self._sr = ctx.sample_rate
        return {"synth": self.synth.init(ctx, self.options.voices)}

    def render_lanes(self, state, params, inputs, live, frame0,
                     ctx: BuildCtx):
        """Render the generator (a pool of one: leading dimension 1 on the
        state, the parameters and the voice arrays), its V voices in one
        batched SynthDef call.  Returns (new state, audio [1, ch, n]).

        In a lane-batched program the pool holds L instances of the
        generator (leading dimension L), each with its own parameters and
        voice arrays: the note logic runs over the L*V voices, lane-major,
        and the SynthDef over L*V voices in one call.  Returns audio
        [L, ch, n]."""
        from ..graph.engine import tree_map
        n = ctx.block_frames
        lanes = len(params[VOLUME.id])
        sr = ctx.sample_rate
        nv = self.options.voices
        voice_no = torch.arange(1, nv + 1, dtype=torch.int64,
                                device=params[VOLUME.id].device)
        if lanes == 1:
            p = {k: x[0] for k, x in params.items()}  # [n]
            vs = {k: x[0] for k, x in inputs.items()}  # [V] or [V, K]
        else:
            p, vs = voice_rows(params, inputs, nv)  # [L*V, n], [L*V, ...]
            voice_no = voice_no.repeat(lanes)
        dev = vs["_trig_time"].device
        f32 = torch.float32
        i = torch.arange(n, dtype=torch.int64, device=dev)

        def auto(lane, nm, current):
            """Per-sample automated value of one descriptor (stepped or
            ramped knots), or the block's constant [V, 1]."""
            key = f"_{lane}_{nm}_t"
            if key not in vs:
                return current[:, None]
            ev = SegmentEvents(vs[key].long(), vs[f"_{lane}_{nm}_v"],
                               live[key])
            return step_targets(current, ev, vs[f"_{lane}_{nm}_r"], n)[1]

        t_time = vs["_trig_time"].to(torch.int64)[:, None]
        has_trig = ((vs["_trig_time"] < n) & (vs["_trig_vol"] > 0.0))[:, None]
        c_on = (vs["_cont_active"] > 0.5)[:, None]
        in_b = (i >= t_time) & has_trig  # [V, n]
        age = torch.where(in_b, i - t_time,
                          vs["_cont_age0"].to(torch.int64)[:, None] + i)
        note = torch.where(in_b, vs["_trig_note"][:, None],
                           vs["_cont_note"][:, None])
        # per-note automation (reference: fundsp voice set_volume /
        # set_panning / set_speed with glide, fundsp/voice.rs:312-380)
        vel = torch.where(in_b, auto("ta", "vol", vs["_trig_vol"]),
                          auto("ca", "vol", vs["_cont_vol"]))
        npan = torch.where(in_b, auto("ta", "pan", vs["_trig_pan"]),
                           auto("ca", "pan", vs["_cont_pan"]))
        # speed arrays carry the absolute multiplier (initial
        # 2^((note-60)/12)); normalising by that makes freq_mult == 1
        # exactly when unautomated
        spd = torch.where(in_b, auto("ta", "spd", vs["_trig_spd"]),
                          auto("ca", "spd", vs["_cont_spd"]))
        freq_mult = spd / note_speed(note)
        rel = torch.where(in_b, vs["_trig_rel"][:, None],
                          vs["_cont_rel"][:, None])
        active = in_b | c_on
        gate = (active & (age.to(f32) < rel) & (age >= 0)).to(f32)

        if self.glide_secs > 0.0:
            # exponential-in-pitch glide from the previous note on retrigger
            gsamples = max(self.glide_secs * sr, 1.0)
            prog = torch.clamp((i - t_time).to(f32) * recip32(gsamples),
                               0.0, 1.0)
            c_note = vs["_cont_note"][:, None]
            pitch = torch.where(in_b, c_note + (vs["_trig_note"][:, None]
                                                - c_note) * prog, note)
            freq = note_to_hz(torch.where(has_trig & c_on, pitch, note))
        else:
            freq = note_to_hz(note)
        freq = freq * freq_mult

        mods = {}
        if self.mod_config is not None:
            src = eval_sources(build_source_specs(self.mod_config, p, sr), age,
                               vel, note, rel, n,
                               seed=(_SEED ^ (0x9E37 * voice_no))[:, None])
            m = apply_matrix(src, vs["_mod_amt"], vs["_mod_bip"],
                             source_polarity(self.mod_config))  # [V, T, n]
            mods = {t: m[:, k] for k, t in enumerate(self.mod_config.targets)}
        sctx = SynthContext(
            freq=freq, gate=gate, velocity=vel, age=age, release_age=rel,
            sample_rate=sr, block_frames=n,
            params={q.id: p[q.id] for q in self.synth.params}, mods=mods)
        synth_state, audio = self.synth.render(
            tree_map(lambda a: a.flatten(0, 1), state["synth"]), sctx)
        if audio.dim() == 2:  # mono: every output channel
            audio = audio[:, None, :].expand(-1, ctx.channels, -1)
        audio = audio.unflatten(0, (lanes, nv))  # [L, V, ch, n]
        g = p[VOLUME.id] * vel * active.to(f32)
        audio = audio * g.view(lanes, -1, 1, n)
        if ctx.channels >= 2:
            left, right = panning_factors(torch.clamp(p[PANNING.id] + npan,
                                                      -1.0, 1.0))
            audio = torch.cat([audio[:, :, :1] * left.view(lanes, -1, 1, n),
                               audio[:, :, 1:2] * right.view(lanes, -1, 1, n),
                               audio[:, :, 2:]], dim=2)
        return ({"synth": tree_map(lambda a: a.unflatten(0, (lanes, nv)),
                                   synth_state)},
                torch.sum(audio, dim=1))
