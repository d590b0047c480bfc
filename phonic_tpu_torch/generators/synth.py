"""Polyphonic synth generator from a SynthDef (port of
``phonic_tpu/generators/synth.py``, the FunDspGenerator analog).

Behavioural spec: reference src/generator/fundsp.rs — a voice-factory
closure produces per-voice FunDSP graphs driven by (gate, freq, volume,
pan) shared vars; note events allocate voices with the sampler's steal
policy; frequency glides morph exponentially between notes
(src/generator/fundsp/voice.rs:312-346, GlideState :538-560).

The Sampler's voice plan (generators/plan.py) places the notes, and its
lowering gives per-voice descriptors: one continuing note and a trigger
slot for every note that starts on the voice in the block (``_trig_*``
[V, K], unused slots past the block).  ``render_lanes`` picks each
sample's note from them (the last slot that started at or before the
sample, else the continuing note), which gives the sample its age, note,
velocity, pan, speed and release, over ``[V, n]``, and renders all V
voices in ONE call of the batched SynthDef (sources/synth.py), so sub3's
filter is one iir2 launch of V rows.  A SynthDef that describes its voice
for the synth kernels (sub3) renders through ops/synthvoice.py instead: on
the card the note logic, the matrix and the voice up to the filter are one
launch (kernel 10), the filter iir2, its output, the gains and the voice
sum another (kernel 11).  A voice's oscillator phases and
filter state run on across the notes it plays; the modulation matrix's
LFOs and envelopes restart at each note, from its age.  Glides are exact
exponential-in-pitch trajectories computed from the note ages, from the
voice's previous note.

Known deviation (from the JAX package): where a voice starts several notes
in one block the port renders each of them, as upstream does; the JAX
package renders only the last (its lowering keeps one trigger per voice).

Deliberate differences: the JAX package's generator has no ``envelope``
attribute, so a voice steal there raises AttributeError inside the
borrowed allocator; here ``envelope = None`` makes a steal take the oldest
voice, as the sampler without an envelope does.  A modulation LFO's
waveform parameter starts at its default's index (the JAX package passes
its name, and no program builds).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..graph.nodes import BuildCtx
from ..modulation.matrix import (
    ModulationRoutings, apply_matrix, build_source_specs, eval_sources,
    source_polarity,
)
from ..ops import synthvoice
from ..ops.convert import panning_factors
from ..ops.synthvoice import Notes, note_logic, voice_seeds
# the module's note helpers (the JAX package's names) live in ops/synthvoice
# beside the note logic
from ..ops.synthvoice import note_speed, note_to_hz  # noqa: F401
from ..params import (DecibelScaling, EnumParameter, FloatParameter,
                      format_gain, format_pan)
from ..sources.synth import SynthContext, SynthDef
from .base import Generator, GeneratorPlaybackOptions
from .sampler import Sampler, voice_rows

# no scheduled stop (the JAX package's name here, as in sources/file.py)
NEVER = np.iinfo(np.int32).max

VOLUME = FloatParameter("SVOL", "Volume", 1e-6, 15.848932, 1.0,
                        scaling=DecibelScaling(-60.0, 24.0), formatter=format_gain)
PANNING = FloatParameter("SPAN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)

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
        self._plan = None  # the voice plan, made at the first lowering
        self._taken = []  # the events taken from ``events``, as tuples
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
        # a modulation LFO's waveform starts at its default's index (the
        # JAX package passes the name, which no program can build from)
        for p in self.PARAMS:
            if isinstance(p, EnumParameter):
                out[p.id] = p.index_of(p.default)
        return out

    # voice allocation: reuse the Sampler's voice plan with a fixed release
    # duration (and its prepare(): lowering needs the output rate), a
    # trigger slot for every note that starts on a voice in a block
    _voice_plan = Sampler._voice_plan
    _lower_notes = Sampler._lower_notes
    _trigger_slots = Sampler._trigger_slots
    duration_frames = Sampler.duration_frames
    prepare = Sampler.prepare

    def lower_block_inputs(self, block_start: int, block_len: int):
        """The Sampler's voice arrays (``_trig_*`` [V, K]); counts the V * K
        trigger slots under ``synth.trigger_slots`` while tracing is on."""
        out = Sampler.lower_block_inputs(self, block_start, block_len)
        tracing.count("synth.trigger_slots", out["_trig_time"].size)
        if self.modulation is not None:
            out["_mod_amt"] = self.modulation.amounts.copy()
            out["_mod_bip"] = self.modulation.bipolar.copy()
        return out

    def _voice_end(self, seg, ctx_sr: int) -> float:
        if seg.release is math.inf:
            return math.inf
        return min(seg.release + self.release_secs * ctx_sr + 1, seg.cut)

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
        [L, ch, n].

        A SynthDef with a kernel description (``SynthDef.kernel``, sub3's)
        renders through ops/synthvoice: on the card as kernels 10, 2 (iir2)
        and 11, on the CPU as their plain version."""
        from ..graph.engine import tree_map
        lanes = len(params[VOLUME.id])
        nv = self.options.voices
        n, sr = ctx.block_frames, ctx.sample_rate
        rows = tree_map(lambda a: a.flatten(0, 1), state["synth"])
        voice = self.synth.kernel
        if voice is not None and not voice.describes(self.synth):
            voice = None
        if voice is not None and params[VOLUME.id].is_cuda:
            with tracing.span("synth.notes"):
                slots = synthvoice.slot_rows(inputs, live, n)
            with tracing.span("synth.voices"):
                mod = None
                if self.mod_config is not None:
                    mod = synthvoice.sources(voice, self.mod_config, params,
                                             inputs["_mod_amt"],
                                             inputs["_mod_bip"], sr)
                synth_state, audio = synthvoice.render_kernels(
                    voice, rows, params, slots, mod, sr, self.glide_secs,
                    ctx.channels, VOLUME.id, PANNING.id)
        else:
            voice_no = torch.arange(1, nv + 1, dtype=torch.int64,
                                    device=params[VOLUME.id].device)
            if lanes == 1:
                p = {k: x[0] for k, x in params.items()}  # [n]
                vs = {k: x[0] for k, x in inputs.items()}  # [V], [V, K], ...
            else:
                p, vs = voice_rows(params, inputs, nv)  # [L*V, n], ...
                voice_no = voice_no.repeat(lanes)
            with tracing.span("synth.notes"):
                notes = note_logic(vs, live, n, sr, self.glide_secs)
            mod = (None if self.mod_config is None else
                   (self.mod_config, vs["_mod_amt"], vs["_mod_bip"]))
            with tracing.span("synth.voices"):
                if voice is not None:
                    synth_state, audio = synthvoice.render_plain(
                        voice, rows, p, notes, mod, voice_no, sr, lanes,
                        ctx.channels, VOLUME.id, PANNING.id)
                else:
                    synth_state, audio = self._voices(rows, p, notes, mod,
                                                      voice_no, lanes, ctx)
        return ({"synth": tree_map(lambda a: a.unflatten(0, (lanes, nv)),
                                   synth_state)}, audio)

    def _voices(self, state, p, notes: Notes, mod, voice_no, lanes: int,
                ctx: BuildCtx):
        """The modulation matrix and the SynthDef over every voice row, then
        each voice's gain and pan, summed per lane: (new state, audio
        [L, ch, n])."""
        n = ctx.block_frames
        sr = ctx.sample_rate
        f32 = torch.float32
        note, age, vel, npan, rel, active, freq = notes
        gate = (active & (age.to(f32) < rel) & (age >= 0)).to(f32)
        mods = {}
        if mod is not None:
            config, amounts, routed = mod
            src = eval_sources(build_source_specs(config, p, sr), age, vel,
                               note, rel, n, seed=voice_seeds(voice_no)[:, None])
            m = apply_matrix(src, amounts, routed,
                             source_polarity(config))  # [V, T, n]
            mods = {t: m[:, k] for k, t in enumerate(config.targets)}
        sctx = SynthContext(
            freq=freq, gate=gate, velocity=vel, age=age, release_age=rel,
            sample_rate=sr, block_frames=n,
            params={q.id: p[q.id] for q in self.synth.params}, mods=mods)
        synth_state, audio = self.synth.render(state, sctx)
        if audio.dim() == 2:  # mono: every output channel
            audio = audio[:, None, :].expand(-1, ctx.channels, -1)
        audio = audio.unflatten(0, (lanes, -1))  # [L, V, ch, n]
        g = p[VOLUME.id] * vel * active.to(f32)
        audio = audio * g.view(lanes, -1, 1, n)
        if ctx.channels >= 2:
            left, right = panning_factors(torch.clamp(p[PANNING.id] + npan,
                                                      -1.0, 1.0))
            audio = torch.cat([audio[:, :, :1] * left.view(lanes, -1, 1, n),
                               audio[:, :, 1:2] * right.view(lanes, -1, 1, n),
                               audio[:, :, 2:]], dim=2)
        return synth_state, torch.sum(audio, dim=1)
