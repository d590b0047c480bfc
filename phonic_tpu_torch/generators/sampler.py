"""Polyphonic sample-playback generator (port of
``phonic_tpu/generators/sampler.py``).

Behavioural spec: reference src/generator/sampler.rs + sampler/voice.rs —
per-voice chain Panned<Amplified<ChannelMapped<PreloadedFileSource>>> with
AHDSR envelope; effective speed = speed_from_note(note) *
2^(transpose/12 + finetune/1200) (voice.rs:144-157); effective volume =
base * note velocity, panning = clamp(base + note) (voice.rs:158-161);
envelope triggered at full volume (velocity scales the amplifier);
voice stealing free -> longest-releasing -> oldest (sampler.rs:826-860);
FourCC parameters STRN/SFTN/SVOL/SPAN + AHDSR AATK/AHLD/ADCY/ASTN/AREL.

The voice plan (generators/plan.py) places the scheduled notes on voices
with the steal policy, block by block, and each block lowers into per-voice
arrays: one *continuing* note descriptor and a *trigger* slot for every
note that starts on the voice in the block (K slots, a power of two, the
unused ones past the block).  ``process`` renders the voices of a
generator pool (graph/batching.LeafBatch) over explicit ``[G, V]`` sampler
and voice dimensions: sample positions are float64 cumsums rounded once to
float32, envelopes the closed-form AHDSR (ops/ahdsr.py), so a note that
starts mid-block is exact: the voice's previous note renders up to the
trigger, the new note from it.  The notes of a voice are live at disjoint
samples, so each voice reads ONE merged position stream, looped or not; the
pool reads every voice of every sampler in one ``ramp_read``.

Known deviation (as in the JAX package): AHDSR parameter changes re-shape
the envelope of already sounding notes analytically.  Where a voice starts
several notes in one block the port renders each of them, as upstream
does: the sampled and the granular sampler, and the synth generator, which
borrows this lowering.  The JAX package renders only the last (its
lowering keeps one trigger per voice).

Granular playback (``with_granular_playback``) renders each voice as a
pool of grains (generators/granular.py) with the modulation matrix
(modulation/) feeding the 7 granular targets.  A granular sampler is a
generator pool of its own; ``process_granular`` takes each sample's note
from the trigger slots, allocates the grains of every voice over
2048-frame chunks (each note start resets the voice's pool there), then
reads every grain of the block in one ``ramp_read`` of the circularly
extended mono buffer.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from .. import tracing
from ..graph.nodes import BuildCtx
from ..io.decoder import AudioFileBuffer
from ..modulation.matrix import (
    TARGETS, ModulationRoutings, apply_matrix, build_source_specs,
    eval_sources, source_polarity,
)
from ..ops import ahdsr as ahdsr_ops
from ..ops import resample as rs
from ..ops.convert import panning_factors
from ..ops.precision import recip32
from ..ops.smoothing import SegmentEvents, step_targets
from ..params import (DecibelScaling, EnumParameter, ExponentialScaling,
                      FloatParameter, IntegerParameter, format_gain, format_pan)
from .base import Generator, GeneratorPlaybackOptions, NoteEvent
from .granular import (
    DIRECTIONS, NEVER, OVERLAP_MODES, POOL_SIZE, WINDOW_MODES, GranularConfig,
    grain_mix, grain_state_init, granular_voice_alloc, source_table,
    window_table,
)
from .plan import NoteSegment, VoicePlan

# granular renders in chunks of this size when the block is a larger
# multiple of it: a slot is reusable only once its grain expired before the
# chunk being allocated, so the chunk size is part of the output
_GRANULAR_CHUNK = 2048

TRANSPOSE = IntegerParameter("STRN", "Transpose", -48, 48, 0, unit="st")
FINETUNE = IntegerParameter("SFTN", "Finetune", -100, 100, 0, unit="ct")
VOLUME = FloatParameter("SVOL", "Volume", 1e-6, 15.848932, 1.0,
                        scaling=DecibelScaling(-60.0, 24.0), formatter=format_gain)
PANNING = FloatParameter("SPAN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)

# envelope parameters, 0..10 s exponentially scaled (sampler.rs:130-181)
ENV_ATTACK = FloatParameter("AATK", "Attack", 0.0, 10.0, 0.01, unit="s",
                            scaling=ExponentialScaling(3.0), smoothing=None)
ENV_HOLD = FloatParameter("AHLD", "Hold", 0.0, 10.0, 0.0, unit="s",
                          scaling=ExponentialScaling(3.0), smoothing=None)
ENV_DECAY = FloatParameter("ADCY", "Decay", 0.0, 10.0, 0.0, unit="s",
                           scaling=ExponentialScaling(3.0), smoothing=None)
ENV_SUSTAIN = FloatParameter("ASTN", "Sustain", 0.0, 1.0, 1.0, smoothing=None)
ENV_RELEASE = FloatParameter("AREL", "Release", 0.0, 10.0, 0.05, unit="s",
                             scaling=ExponentialScaling(3.0), smoothing=None)

# the lowered arrays a generator holds per voice (the others per generator)
VOICE_KEYS = ("_trig_", "_cont_", "_ta_", "_ca_")


def voice_rows(params, voices, nv: int):
    """A generator pool of one with L instances: its parameters [L, n] and
    lowered arrays ([L, V, ...] per voice, [L, ...] per generator) as rows
    per voice, lane-major: [L*V, n] and [L*V, ...]."""
    p = {k: x.repeat_interleave(nv, 0) for k, x in params.items()}
    vs = {k: x.flatten(0, 1) if k.startswith(VOICE_KEYS)
          else x.repeat_interleave(nv, 0) for k, x in voices.items()}
    return p, vs


def note_of(t_time, n: int):
    """Each sample's note among a voice's continuing note and its trigger
    slots: the number of slots at or before the sample (0 the continuing
    note, j + 1 slot j's).  ``t_time`` [..., K] sorted, unused slots at
    ``n``; returns [..., n]."""
    k = t_time.shape[-1]
    rows = t_time.numel() // k
    ii = torch.arange(n, dtype=t_time.dtype, device=t_time.device)
    return torch.searchsorted(
        t_time.reshape(rows, k).contiguous(), ii.expand(rows, n).contiguous(),
        right=True).view(t_time.shape[:-1] + (n,))


def per_note(cont, trig):
    """A note quantity's table [..., K+1]: column 0 the continuing note's
    ``cont`` [...], column j + 1 trigger slot j's ``trig`` [..., K]."""
    return torch.cat([cont[..., None], trig], dim=-1)


def note_envelope(env_p, ages, rel, rels, notes):
    """The voice AHDSR of each sample's note: ``ages`` and ``rel`` (its
    note-off age) per sample, ``rels`` the note-off table [..., K+1] and
    ``notes`` each sample's note (:func:`note_of`)."""
    level = ahdsr_ops.release_level(env_p, 1.0, rels).gather(-1, notes)
    return ahdsr_ops.ahdsr_values(env_p, 1.0, ages, rel, level)


# granular parameters (sampler.rs:219-296)
GRAIN_OVERLAP = EnumParameter("GOVM", "Overlap Mode", OVERLAP_MODES, "Cloud")
GRAIN_WINDOW = EnumParameter("GWND", "Window", WINDOW_MODES, "Hann")
GRAIN_SIZE = FloatParameter("GSIZ", "Grain Size", 1.0, 1000.0, 100.0, unit="ms",
                            scaling=ExponentialScaling(2.0), smoothing=None)
GRAIN_DENSITY = FloatParameter("GDEN", "Density", 1.0, 100.0, 10.0, unit="Hz",
                               scaling=ExponentialScaling(2.0), smoothing=None)
GRAIN_VARIATION = FloatParameter("GVAR", "Variation", 0.0, 1.0, 0.0, smoothing=None)
GRAIN_SPRAY = FloatParameter("GSPY", "Spray", 0.0, 1.0, 0.0, smoothing=None)
GRAIN_PAN_SPREAD = FloatParameter("GPAN", "Pan Spread", 0.0, 1.0, 0.0, smoothing=None)
GRAIN_DIRECTION = EnumParameter("GDIR", "Direction", DIRECTIONS, "Forward")
GRAIN_POSITION = FloatParameter("GPOS", "Position", 0.0, 1.0, 0.5, smoothing=None)
GRAIN_STEP = FloatParameter("GSTP", "Step", -4.0, 4.0, 0.0, unit="x", smoothing=None)
LFO1_RATE = FloatParameter("ML1R", "LFO 1 Rate", 0.01, 20.0, 1.0, unit="Hz", smoothing=None)
LFO1_WAVE = EnumParameter("ML1W", "LFO 1 Waveform",
                          ("Sine", "Triangle", "Ramp Up", "Ramp Down", "Square",
                           "Random", "Smooth Random"), "Sine")
LFO2_RATE = FloatParameter("ML2R", "LFO 2 Rate", 0.01, 20.0, 2.0, unit="Hz", smoothing=None)
LFO2_WAVE = EnumParameter("ML2W", "LFO 2 Waveform",
                          ("Sine", "Triangle", "Ramp Up", "Ramp Down", "Square",
                           "Random", "Smooth Random"), "Sine")

GRANULAR_PARAMS = (GRAIN_OVERLAP, GRAIN_WINDOW, GRAIN_SIZE, GRAIN_DENSITY,
                   GRAIN_VARIATION, GRAIN_SPRAY, GRAIN_PAN_SPREAD,
                   GRAIN_DIRECTION, GRAIN_POSITION, GRAIN_STEP,
                   LFO1_RATE, LFO1_WAVE, LFO2_RATE, LFO2_WAVE)


@dataclasses.dataclass
class AhdsrConfig:
    attack: float = 0.01
    hold: float = 0.0
    decay: float = 0.0
    sustain: float = 1.0
    release: float = 0.05


class Sampler(Generator):
    PARAMS = (TRANSPOSE, FINETUNE, VOLUME, PANNING,
              ENV_ATTACK, ENV_HOLD, ENV_DECAY, ENV_SUSTAIN, ENV_RELEASE)

    def __init__(
        self,
        buffer: AudioFileBuffer,
        options: Optional[GeneratorPlaybackOptions] = None,
        envelope: Optional[AhdsrConfig] = None,
        transpose: int = 0,
        finetune: int = 0,
        name=None,
    ):
        super().__init__(options, name)
        self.buffer = buffer
        self.envelope = envelope
        self.transpose = int(transpose)
        self.finetune = int(finetune)
        self.granular: Optional[GranularConfig] = None
        self.modulation = ModulationRoutings()
        self.mod_config = self.modulation.config
        self.seed = 0x6A17
        self._loop_msgs: list = []  # (time, Optional[(start, end)])
        self._plan = None  # the voice plan, made at the first lowering
        self._taken = []  # the events taken from ``events``, as tuples
        self._mono_cache = None
        self._timelines = {}  # set by the RenderProgram that owns the node
        self.PARAMS = Sampler.PARAMS  # extended by with_granular_playback

    @property
    def WEIGHT(self):  # reference: weight = active voices (sampler.rs:970)
        return max(self.options.voices, 1)

    @classmethod
    def from_file(cls, path, **kwargs) -> "Sampler":
        return cls(AudioFileBuffer.from_file(path), **kwargs)

    def source_batch_key(self, ctx):
        """Static-config signature of a generator pool
        (graph/batching.LeafBatch): samplers whose keys match render as one
        pool.  Buffer LENGTH rides in per sampler (``_buf_frames``), so only
        its coarse bucket is in the key; it bounds the zero-padding of a
        pool's buffer table.  A granular sampler renders alone (None), as
        in the JAX package."""
        if self.granular is not None:
            return None
        return (
            self.options.voices,
            self.envelope is not None,
            self.buffer.channels,
            self.buffer.sample_rate,
            self.buffer.loop_mode,
            # the never-loops program lowers no _loop_* inputs
            self._can_loop(),
            round(self.options.fade_out_secs, 9),
            rs.length_bucket(self.buffer.frames),
        )

    def with_ahdsr(self, attack=0.01, hold=0.0, decay=0.0, sustain=1.0,
                   release=0.05) -> "Sampler":
        self.envelope = AhdsrConfig(attack, hold, decay, sustain, release)
        return self

    def with_granular_playback(self, config: Optional[GranularConfig] = None) -> "Sampler":
        """Enable granular mode (reference: sampler.rs:598-637): the buffer is
        monoized + resampled to the output rate for grain reads, granular +
        modulation parameters activate, and each voice gets a grain pool."""
        self.granular = config or GranularConfig()
        self.PARAMS = Sampler.PARAMS + GRANULAR_PARAMS
        return self

    def with_modulation(self, config) -> "Sampler":
        """Install a custom ModulationConfig (modulation/config.py): extra
        LFO slots and AHDSR Envelope sources become routable to the 7
        granular targets, with their rate/waveform/AHDSR parameters exposed
        as engine-smoothed FourCC parameters (reference: the generalized
        ModulationConfig of src/modulation.rs:135-155; the stock sampler
        config is src/generator/sampler.rs:362-427).  Requires granular
        playback (the matrix only feeds granular targets, like the
        reference sampler)."""
        if self.granular is None:
            raise ValueError("call with_granular_playback() before "
                             "with_modulation(): the sampler matrix feeds "
                             "the granular targets")
        if tuple(config.targets) != TARGETS:
            raise ValueError(f"sampler modulation targets must be {TARGETS}")
        self.mod_config = config
        self.modulation = ModulationRoutings(config)
        have = {p.id for p in self.PARAMS}
        extra = tuple(p for p in config.source_parameters() if p.id not in have)
        self.PARAMS = self.PARAMS + extra
        return self

    def set_modulation(self, source: str, target: str, amount: float,
                       bipolar: bool = True):
        self.modulation.set(source, target, amount, bipolar)

    def clear_modulation(self, source: str, target: str):
        self.modulation.clear(source, target)

    def set_loop_range(self, loop_range, time: int = 0):
        """SamplerMessage::SetLoopRange (reference: sampler.rs:51-55,
        validated + applied at :1246-1270): change or disable looping at
        runtime.  Applies at block granularity, like the reference's
        message-queue drain.  ``loop_range`` is (start, end) in source
        frames or None to disable looping."""
        if loop_range is not None:
            start, end = int(loop_range[0]), int(loop_range[1])
            frames = self.buffer.frames
            if not (0 <= start < frames and start < end <= frames):
                raise ValueError(
                    f"Invalid loop range {loop_range!r}; loop must be in "
                    f"range 0..{frames}")
            loop_range = (start, end)
        self._loop_msgs.append((int(time), loop_range))

    def handle_message(self, message, time: int = 0):
        """Generic message hook: accepts ('set_loop_range', range) tuples or
        a bare range/None (reference: Generator::process_message)."""
        if isinstance(message, tuple) and len(message) == 2 and \
                message[0] == "set_loop_range":
            self.set_loop_range(message[1], time=time)
        else:
            self.set_loop_range(message, time=time)

    def _loop_at(self, t: int):
        """Loop range in effect at output frame ``t``."""
        current = self.buffer.loop_range
        for mt, rng in sorted(self._loop_msgs, key=lambda m: m[0]):
            if mt <= t:
                current = rng
        return current

    def _can_loop(self) -> bool:
        """Can looping EVER engage in this program?  False when the buffer
        carries no loop range and no SetLoopRange message has been
        enqueued; the lowering then omits the ``_loop_*`` inputs and the
        render skips the fold."""
        return self.buffer.loop_range is not None or bool(self._loop_msgs)

    def _mono_buffer(self, sample_rate: int) -> np.ndarray:
        """Mono buffer at the output rate for grain reads
        (reference: create_granular_sample_buffer, sampler.rs:908-952)."""
        if self._mono_cache is not None and self._mono_cache[0] == sample_rate:
            return self._mono_cache[1]
        data = np.asarray(self.buffer.data[:, :-1], np.float32)  # drop guard
        mono = data.mean(axis=0)
        if self.buffer.sample_rate != sample_rate:
            ratio = self.buffer.sample_rate / sample_rate
            n_out = max(int(len(mono) / ratio), 1)
            pos = np.arange(n_out) * ratio
            k = np.floor(pos).astype(np.int64)
            fr = (pos - k).astype(np.float32)
            def g(i):
                return np.where((i >= 0) & (i < len(mono)), mono[np.clip(i, 0, len(mono) - 1)], 0.0)
            ym1, y0, y1, y2 = g(k - 1), g(k), g(k + 1), g(k + 2)
            c1 = (y1 - ym1) * 0.5
            c2 = ym1 - y0 * 2.5 + y1 * 2.0 - y2 * 0.5
            c3 = (y2 - ym1) * 0.5 + (y0 - y1) * 1.5
            mono = (((c3 * fr + c2) * fr + c1) * fr + y0).astype(np.float32)
        self._mono_cache = (sample_rate, mono)
        return mono

    def read_table(self, sample_rate: int):
        """(rows [ch, F], read lanes) of this sampler in its pool's buffer
        table (graph/batching.LeafBatch): the buffer with its guard frame and
        one lane per voice, or, in granular mode, the circularly extended
        mono buffer and one lane per grain slot."""
        if self.granular is not None:
            return (source_table(self._mono_buffer(sample_rate))[0],
                    self.options.voices * POOL_SIZE)
        return np.asarray(self.buffer.data), self.options.voices

    def param_initials(self):
        env = self.envelope or AhdsrConfig()
        d = {TRANSPOSE.id: self.transpose, FINETUNE.id: self.finetune,
             VOLUME.id: self.options.volume, PANNING.id: self.options.panning,
             ENV_ATTACK.id: env.attack, ENV_HOLD.id: env.hold,
             ENV_DECAY.id: env.decay, ENV_SUSTAIN.id: env.sustain,
             ENV_RELEASE.id: env.release}
        if self.granular is not None:
            g = self.granular
            d.update({
                GRAIN_OVERLAP.id: GRAIN_OVERLAP.index_of(g.overlap_mode),
                GRAIN_WINDOW.id: GRAIN_WINDOW.index_of(g.window),
                GRAIN_SIZE.id: g.size_ms, GRAIN_DENSITY.id: g.density_hz,
                GRAIN_VARIATION.id: g.variation, GRAIN_SPRAY.id: g.spray,
                GRAIN_PAN_SPREAD.id: g.pan_spread,
                GRAIN_DIRECTION.id: GRAIN_DIRECTION.index_of(g.direction),
                GRAIN_POSITION.id: g.position, GRAIN_STEP.id: g.step,
                LFO1_RATE.id: 1.0, LFO1_WAVE.id: 0, LFO2_RATE.id: 2.0,
                LFO2_WAVE.id: 0,
            })
        return d

    # ------------------------------------------------------------------
    # host-side voice allocation (reference steal policy, sampler.rs:826-860)
    # ------------------------------------------------------------------

    def _voice_end(self, seg: NoteSegment, ctx_sr: int) -> float:
        """Frame at which the voice becomes free again."""
        if self.envelope is not None:
            if seg.release is math.inf:
                return math.inf
            return min(seg.release + self.envelope.release * ctx_sr * 0.999 + 1, seg.cut)
        # no envelope: one-shot ends at buffer end (note speed scaled)
        speed = 2.0 ** ((seg.note - 60) / 12.0 + self.transpose / 12.0 + self.finetune / 1200.0)
        step = speed * self.buffer.sample_rate / ctx_sr  # source frames/output frame
        nat = seg.start + self.buffer.frames / max(step, 1e-9)
        if self.buffer.loop_range is not None:
            nat = math.inf
        end = nat
        if seg.release is not math.inf:
            end = min(end, seg.release + self.options.fade_out_secs * ctx_sr + 1)
        return min(end, seg.cut)

    def _voice_plan(self, sample_rate: int,
                    block_start: int = None) -> VoicePlan:
        """The generator's voice plan (generators/plan.py), with the events
        scheduled since the last call (``events``) taken into it and kept,
        as plain tuples, in ``_taken``.  A plan at another rate, or one that
        has moved past ``block_start`` (a program that renders the generator
        again from an earlier block), is made anew from every event taken
        so far."""
        plan = self._plan
        if plan is None or plan.sr != sample_rate or (
                block_start is not None and block_start < plan.pruned_to):
            plan = self._plan = VoicePlan(self, sample_rate)
            plan.take([NoteEvent(*e) for e in self._taken])
        if self.events:
            events, self.events = self.events, []
            plan.take(events)
            self._taken.extend(ev.plain() for ev in events)
        return plan

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        plan = self._voice_plan(ctx.sample_rate).finished()
        total = 0
        for segs in plan.voices:
            for seg in segs:
                end = self._voice_end(seg, ctx.sample_rate)
                if end is math.inf:
                    return None
                total = max(total, int(end))
        return total

    def prepare(self, ctx: BuildCtx) -> None:
        # the engine hands us the output rate at program build so lowering
        # never falls back to a default
        self._sr = ctx.sample_rate

    def _max_step_bound(self, plan: VoicePlan,
                        include_ratio: bool = True) -> float:
        """Upper bound on any voice's per-sample read step: the largest note
        speed ever scheduled (incl. set_note_speed targets) x the
        transpose/finetune parameter bound x the rate ratio.

        ``include_ratio=False`` gives the bound in SOURCE frames per output
        sample for a buffer already resampled to the engine rate (the
        granular mono buffer)."""
        def tl_max(pid, initial):
            tl = self._timelines.get(pid)
            vals = [float(initial)]
            if tl is not None:
                vals.append(tl.initial)
                vals.extend(tl.values)
            return max(vals)

        pitch = 2.0 ** (tl_max(TRANSPOSE.id, self.transpose) / 12.0
                        + tl_max(FINETUNE.id, self.finetune) / 1200.0)
        ratio = (self.buffer.sample_rate / self._sr) if include_ratio else 1.0
        return pitch * plan.max_speed * ratio

    def lower_block_inputs(self, block_start: int, block_len: int):
        """The block's voice arrays: each voice's continuing note
        (``_cont_*`` [V]) and every note that starts on it in the block, in
        trigger slots ``_trig_*`` [V, K] sorted by time (unused slots at
        ``block_len``; K a power of two), for the sampled and the granular
        sampler alike, and for the synth generator, which borrows this (the
        JAX package lowers the last start only, ``_trig_*`` [V]).
        ``_smax`` is the step bound 2**bucket (monotone over the program's
        life), the JAX package's read-window tag."""
        if not hasattr(self, "_sr"):
            raise RuntimeError(
                f"{type(self).__name__} lowered before prepare(); the node "
                "must be part of a RenderProgram")
        with tracing.span("generator.plan"):
            plan = self._voice_plan(self._sr, block_start)
            notes = plan.block(block_start, block_len)
        with tracing.span("generator.lower"):
            return self._lower_notes(plan, notes, block_start, block_len)

    def _lower_notes(self, plan: VoicePlan, notes, block_start: int,
                     block_len: int) -> dict:
        v = self.options.voices
        k = max((len(trigs) for _, trigs in notes), default=0)
        shape = (v, 1 << max(k - 1, 0).bit_length())
        out = {
            "_cont_active": np.zeros(v, np.float32),
            "_cont_note": np.full(v, 60.0, np.float32),
            "_cont_vol": np.zeros(v, np.float32),
            "_cont_pan": np.zeros(v, np.float32),
            "_cont_age0": np.zeros(v, np.int32),
            "_cont_rel": np.full(v, np.inf, np.float32),
            "_cont_spd": np.ones(v, np.float32),
            "_trig_time": np.full(shape, block_len, np.int32),
            "_trig_note": np.full(shape, 60.0, np.float32),
            "_trig_vol": np.zeros(shape, np.float32),
            "_trig_pan": np.zeros(shape, np.float32),
            "_trig_rel": np.full(shape, np.inf, np.float32),
            "_trig_spd": np.ones(shape, np.float32),
        }
        # Per-note automation events per note (cont "ca" / trig "ta"), K
        # knots per block so speed-glide ramps lower losslessly; emitted
        # only once ANY per-note automation exists
        has_auto = plan.has_auto
        ka = max(4, block_len // 512)
        if has_auto:
            for lane, sh in (("ca", (v,)), ("ta", shape)):
                for nm in ("vol", "pan", "spd"):
                    out[f"_{lane}_{nm}_t"] = np.full(sh + (ka,), block_len,
                                                     np.int32)
                    out[f"_{lane}_{nm}_v"] = np.zeros(sh + (ka,), np.float32)
                    out[f"_{lane}_{nm}_r"] = np.zeros(sh + (ka,), np.float32)

        def _lower_auto(seg, lane, at):
            if not has_auto:
                return
            for nm, tl in (("vol", seg.vol_tl), ("pan", seg.pan_tl),
                           ("spd", seg.spd_tl)):
                if tl is not None:
                    t_, v_, r_ = tl.lower_block(block_start, block_len, ka)
                    out[f"_{lane}_{nm}_t"][at] = t_
                    out[f"_{lane}_{nm}_v"][at] = v_
                    out[f"_{lane}_{nm}_r"][at] = r_

        def _lower_trig(seg, at):
            out["_trig_time"][at] = seg.start - block_start
            out["_trig_note"][at] = seg.note
            out["_trig_vol"][at] = seg.volume
            out["_trig_pan"][at] = seg.panning
            out["_trig_spd"][at] = seg.speed0()
            if seg.release is not math.inf:
                out["_trig_rel"][at] = seg.release - seg.start
            _lower_auto(seg, "ta", at)

        if self.granular is not None:
            out["_mod_amt"] = self.modulation.amounts.copy()
            out["_mod_bip"] = self.modulation.bipolar.copy()
        # the read's inputs exist only where there is a buffer: a
        # SynthGenerator borrows this lowering and has none
        if getattr(self, "buffer", None) is not None:
            self._lower_read_inputs(out, plan, block_start)
        segments = 0
        for vi, (cont, trigs) in enumerate(notes):
            segments += (cont is not None) + len(trigs)
            if cont is not None:
                out["_cont_active"][vi] = 1.0
                out["_cont_note"][vi] = cont.note
                out["_cont_vol"][vi] = (cont.vol_tl.value_at(block_start)
                                        if cont.vol_tl else cont.volume)
                out["_cont_pan"][vi] = (cont.pan_tl.value_at(block_start)
                                        if cont.pan_tl else cont.panning)
                out["_cont_spd"][vi] = (cont.spd_tl.value_at(block_start)
                                        if cont.spd_tl else cont.speed0())
                out["_cont_age0"][vi] = block_start - cont.start
                _lower_auto(cont, "ca", vi)
                if cont.release is not math.inf:
                    out["_cont_rel"][vi] = cont.release - cont.start
            # a cut is where the note that stole the voice starts: a slot
            for j, seg in enumerate(trigs):
                _lower_trig(seg, (vi, j))
        tracing.count("generator.segments", segments)
        return out

    def _lower_read_inputs(self, out: dict, plan: VoicePlan,
                           block_start: int):
        """The lowered inputs of the buffer read: the step bound ``_smax``,
        the ``_loop_*`` inputs and the live buffer length."""
        if self.granular is not None:
            # grain read speed = voice speed x 2^(sem/12), |sem| <= var <= 1
            # semitone (granular.rs:700-717 variation draws); the mono
            # buffer is pre-resampled to the engine rate (ratio 1).  The
            # config's max_read_speed caps the bound either way.
            b = min(rs.speed_bucket(
                        self._max_step_bound(plan, include_ratio=False)
                        * 2.0 ** (1.0 / 12.0)),
                    rs.speed_bucket(self.granular.max_read_speed))
        else:
            b = rs.speed_bucket(self._max_step_bound(plan))
        # step bound (monotone: a shrinking bound would change the clamp
        # mid-note)
        self._spd_bucket = max(b, getattr(self, "_spd_bucket", 0))
        out["_smax"] = np.float32(2.0 ** self._spd_bucket)
        # _loop_* inputs exist only when looping can engage (_can_loop);
        # granular always lowers them
        if self.granular is not None or self._can_loop():
            rng = self._loop_at(block_start)
            out["_loop_on"] = np.float32(0.0 if rng is None else 1.0)
            out["_loop_start"] = np.float32(0.0 if rng is None else rng[0])
            out["_loop_end"] = np.float32(
                self.buffer.frames if rng is None else rng[1])
        # live buffer length: samplers of one pool pad to its longest
        out["_buf_frames"] = np.float32(self.buffer.frames)

    # ------------------------------------------------------------------
    # device-side rendering
    # ------------------------------------------------------------------

    def init_state(self, ctx: BuildCtx):
        """Each voice's carried read position ``base + frac`` and, in granular
        mode, its grain pool; the sample data lives in the pool's buffer
        table (graph/batching.LeafBatch)."""
        self._sr = ctx.sample_rate
        v = self.options.voices
        st = {"base": torch.zeros(v, dtype=torch.int32, device=ctx.device),
              "frac": torch.zeros(v, dtype=torch.float32, device=ctx.device)}
        if self.granular is not None:
            st["grains"] = grain_state_init(POOL_SIZE, v, ctx.device)
        return st

    def process(self, state, params, voices, smax: float, live: dict,
                read, ctx: BuildCtx):
        """Render the V voices of G samplers that share this sampler's
        ``source_batch_key`` (a generator pool).

        state: {"base", "frac"} [G, V]; params: each parameter [G, n];
        voices: the lowered arrays as tensors, [G] per sampler, [G, V] per
        voice, [G, V, K] per trigger slot, [G, V, (K,) knots] per
        automation array; smax: the pool's step bound; live: per automation
        ``_t`` key, the segments that can start in the block (host-known,
        see ops/smoothing.SegmentEvents); read: positions [G*V, n] -> audio
        [G*V, ch, n], the pool's one read.

        Each voice plays its continuing note until its first trigger, then
        each triggered note until the next: the notes are live at disjoint
        samples, so the voice reads ONE merged position stream, and every
        per-note quantity is picked per sample from a [G, V, K+1] table
        (column 0 the continuing note, column j+1 trigger slot j).
        Returns (new state, audio [G, ch, n])."""
        n = ctx.block_frames
        g, v = state["base"].shape
        dev = state["base"].device
        ratio = float(np.float32(self.buffer.sample_rate / ctx.sample_rate))
        ii = torch.arange(n, dtype=torch.int32, device=dev)
        t_time = voices["_trig_time"]  # [G, V, K], sorted, unused slots at n
        k = t_time.shape[-1]

        notes = note_of(t_time, n)  # [G, V, n]

        def at(table):  # [G, V, K+1] -> each sample's note's value [G, V, n]
            return table.gather(-1, notes)

        def per_sampler(x):  # [G] -> [G, 1, 1]
            return x[:, None, None]

        pitch = torch.exp2(params[TRANSPOSE.id] / 12.0
                           + params[FINETUNE.id] / 1200.0)[:, None, :]  # [G, 1, n]

        def knots(lane, nm, current, rows):
            """Per-sample automated values of ``rows`` notes (stepped or
            ramped knots, ops/smoothing.step_targets)."""
            key = f"_{lane}_{nm}_t"
            ev = SegmentEvents(voices[key].reshape(rows, -1).long(),
                               voices[f"_{lane}_{nm}_v"].reshape(rows, -1),
                               live[key])
            ramps = voices[f"_{lane}_{nm}_r"].reshape(rows, -1)
            return step_targets(current.reshape(-1), ev, ramps, n)[1]

        def note_value(nm, cont, trig):
            """Each sample's value of one note quantity: its note's
            automation, or the note's constant."""
            if f"_ca_{nm}_t" not in voices:
                return at(per_note(cont, trig))
            both = torch.cat([knots("ca", nm, cont, g * v).view(g, v, 1, n),
                              knots("ta", nm, trig, g * v * k).view(g, v, k, n)],
                             dim=2)
            return both.gather(2, notes[:, :, None]).squeeze(2)

        # the read positions: the steps' running sum in float64, rounded
        # once, so that it does not depend on the device's order of
        # summation; the continuing note goes on from the carried position,
        # a triggered note starts at 0
        sounding = (notes > 0) | (voices["_cont_active"] > 0.5)[..., None]
        spd = note_value("spd", voices["_cont_spd"], voices["_trig_spd"])
        # the JAX package's windowed reads need steps <= smax (never binds
        # in-bucket); clamping here keeps the positions equal
        steps = torch.where(sounding,
                            torch.clamp(pitch * spd * ratio, max=smax), 0.0)
        run = torch.cumsum(steps.to(torch.float64), dim=-1)
        before = torch.cat([torch.zeros_like(run[..., :1]), run[..., :-1]],
                           dim=-1)
        origin = per_note(torch.zeros_like(run[..., 0]), before.gather(
            -1, t_time.clamp(max=n - 1).long()))  # [G, V, K+1]
        since = at(origin)
        walked = (before - since).to(torch.float32)
        carried = state["base"].to(torch.float32) + state["frac"]
        cont = notes == 0
        pos = torch.where(cont, carried[..., None] + walked, walked)
        end_pos = torch.where(cont[..., -1], pos[..., -1] + steps[..., -1],
                              (run[..., -1] - since[..., -1]).to(torch.float32))
        new_base = torch.floor(end_pos)

        frames_live = per_sampler(voices["_buf_frames"])
        if "_loop_on" in voices:
            loop_on = per_sampler(voices["_loop_on"] > 0.5)
            folded = rs.loop_fold(pos, per_sampler(voices["_loop_start"]),
                                  per_sampler(voices["_loop_end"]),
                                  self.buffer.loop_mode)
            live_pos = loop_on | (pos < frames_live)
            pos = torch.where(loop_on, folded, pos)
        else:
            live_pos = pos < frames_live
        mask = sounding & live_pos
        audio = read(pos.reshape(g * v, n)).reshape(g, v, -1, n)

        # the note each sample belongs to: age, note-off run, volume, pan
        ages = ii + at(per_note(voices["_cont_age0"], -t_time))
        rels = per_note(voices["_cont_rel"], voices["_trig_rel"])
        rel = at(rels)
        if self.envelope is not None:
            env_p = ahdsr_ops.ahdsr_params(
                ctx.sample_rate, *(per_sampler(params[p.id][:, 0]) for p in (
                    ENV_ATTACK, ENV_HOLD, ENV_DECAY, ENV_SUSTAIN, ENV_RELEASE)))
            env = note_envelope(env_p, ages, rel, rels, notes)
        else:
            # one-shot: the de-click fade after note-off
            fade_log1m = math.log1p(-(1.0 - math.exp(
                -1.0 / max(ctx.sample_rate * self.options.fade_out_secs
                           / math.log(100.0), 1e-9))))
            agef = ages.to(torch.float32)
            down = torch.exp(fade_log1m * torch.clamp(agef - rel + 1.0, min=0.0))
            env = torch.where(agef < rel, 1.0,
                              torch.where(down < 1e-4, 0.0, down))
        vol = note_value("vol", voices["_cont_vol"], voices["_trig_vol"])
        pan = note_value("pan", voices["_cont_pan"], voices["_trig_pan"])
        base_vol = params[VOLUME.id][:, None, :]
        base_pan = params[PANNING.id][:, None, :]
        gain = env * (base_vol * vol) * mask.to(torch.float32)

        if self.buffer.channels >= 2 and ctx.channels >= 2:
            chans = [audio[:, :, 0] * gain, audio[:, :, 1] * gain]
        else:
            mono = audio.mean(dim=2) if audio.shape[2] > 1 else audio[:, :, 0]
            chans = [mono * gain] * ctx.channels
        if ctx.channels >= 2:
            left, right = panning_factors(torch.clamp(base_pan + pan, -1.0, 1.0))
            chans[0], chans[1] = chans[0] * left, chans[1] * right
        mix = torch.stack([c.sum(dim=1) for c in chans], dim=1)
        return {"base": new_base.to(torch.int32),
                "frac": end_pos - new_base}, mix

    def process_granular(self, state, params, voices, smax: float,
                         frame0, read, ctx: BuildCtx):
        """Render a granular sampler, a generator pool of one, with the
        modulation matrix feeding the 7 granular targets.  The state has a
        leading dimension L, the sampler's instances in a lane-batched
        program (1 otherwise), and so do the parameters ``[L, n]`` and the
        voice arrays: each instance's own.

        The voices' note logic and modulation run over ``[V, n]`` for one
        instance and over ``[L*V, n]`` (lane-major) for several, the
        per-sample parameters then per voice; the grain pools of every
        instance run over ``[L*V, ...]``.  Each sample's note comes from
        the voice's trigger slots (``_trig_*`` [V, K]) as in ``process``,
        and with it the global frame the note started at, which
        ``granular_voice_alloc`` resets the pool at.  The grain pools
        allocate chunk by chunk (the JAX
        package's hoisted-read formulation, sampler.py:1029-1083): each
        chunk's read positions and weights go into ``[V*POOL, n]`` tensors,
        and since the reads never feed back into allocation, every grain of
        the block is read in ONE ``read`` call afterwards ([V*POOL, n]
        positions -> [V*POOL, 1, n], the pool's ramp_read; [L*V*POOL, n]
        for L instances), then mixed with each chunk's pans and shaped by
        the voice AHDSR.  ``frame0`` is the block's global start frame, a
        host int, or each instance's as an int64 tensor [L].
        Returns (new state, audio [L, ch, n])."""
        n = ctx.block_frames
        sr = ctx.sample_rate
        nv = self.options.voices
        dev = state["base"].device
        lanes = state["base"].shape[0]
        lv = lanes * nv
        f32 = torch.float32
        voice_no = torch.arange(1, nv + 1, dtype=torch.int64, device=dev)
        if lanes == 1:
            p = {k: x[0] for k, x in params.items()}  # [n]
            vs = {k: x[0] for k, x in voices.items()}  # [V], [S, T] or 0-d

            def first(x):  # a parameter's value at the block's start
                return x[0]
        else:
            p, vs = voice_rows(params, voices, nv)  # [L*V, n], [L*V, ...]
            voice_no = voice_no.repeat(lanes)

            def first(x):
                return x[:, :1]
        if isinstance(frame0, torch.Tensor):  # each voice's instance's
            frame0 = frame0.repeat_interleave(nv)
        frames = len(self._mono_buffer(sr))
        # runtime loop range, normalized over the source length
        inv_len = np.float32(1.0 / float(self.buffer.frames))
        loop_norm = (vs["_loop_on"], vs["_loop_start"] * inv_len,
                     vs["_loop_end"] * inv_len)
        # grain read speed cap: the config's, within the host's step bound
        eff_mrs = min(float(self.granular.max_read_speed), smax)

        i = torch.arange(n, dtype=torch.int64, device=dev)
        pitch = torch.exp2((p[TRANSPOSE.id] * recip32(12.0)
                            + p[FINETUNE.id] * recip32(1200.0)).to(torch.float64)
                           ).to(f32)
        t_time = vs["_trig_time"].to(torch.int64)  # [R, K], sorted
        cn = (_GRANULAR_CHUNK if n > _GRANULAR_CHUNK and n % _GRANULAR_CHUNK == 0
              else n)
        max_triggers = int(math.ceil(100.0 * cn / sr)) + 2
        tracing.count("granular.trigger_slots", t_time.numel())
        tracing.count("granular.alloc_steps", (n // cn) * max_triggers)

        with tracing.span("granular.notes"):
            # --- the voices' note logic over [R, n]: each voice plays its
            # continuing note until its first trigger slot, then each
            # triggered note until the next (a [R, K+1] table per note
            # quantity, column 0 the continuing note, as ``process``) ---
            notes = note_of(t_time, n)  # [R, n]
            c_on = vs["_cont_active"] > 0.5
            c_age0 = vs["_cont_age0"].to(torch.int64)

            def note_value(cont, trig):  # each sample's note's value [R, n]
                return per_note(cont, trig).gather(-1, notes)

            age = i + note_value(c_age0, -t_time)
            note = note_value(vs["_cont_note"], vs["_trig_note"])
            nvol = note_value(vs["_cont_vol"] * vs["_cont_active"],
                              vs["_trig_vol"])
            npan = note_value(vs["_cont_pan"], vs["_trig_pan"])
            rels = per_note(vs["_cont_rel"], vs["_trig_rel"])
            rel = rels.gather(-1, notes)
            active = (notes > 0) | c_on[:, None]
            held = active & (age.to(f32) < rel) & (nvol > 0.0)
            # the global frame each sample's note started at (NEVER: none)
            f0 = frame0[:, None] if isinstance(frame0, torch.Tensor) else frame0
            cont_start = torch.where(c_on[:, None], f0 - c_age0[:, None],
                                     NEVER)[:, 0]
            note_start = note_value(cont_start, f0 + t_time)
            # per-note speed automation applies at block granularity for
            # grains (the pool re-reads speed per trigger, granular.rs:504)
            speed = pitch * note_value(vs["_cont_spd"], vs["_trig_spd"])

            # modulation sources and targets of every voice
            src = eval_sources(build_source_specs(self.mod_config, p, sr), age,
                               nvol, note, rel, n,
                               seed=(self.seed ^ (0x9E37 * voice_no))[:, None])
            mods = apply_matrix(src, vs["_mod_amt"], vs["_mod_bip"],
                                source_polarity(self.mod_config))  # [.., 7, n]
            per_sample = dict(
                held=held, speed=speed, vol=p[VOLUME.id] * nvol,
                note_start=note_start,
                pan=torch.clamp(p[PANNING.id] + npan, -1.0, 1.0),
                size_ms=p[GRAIN_SIZE.id] * (1.0 + mods[:, 0]),
                density=p[GRAIN_DENSITY.id] * (1.0 + mods[:, 1]),
                variation=p[GRAIN_VARIATION.id] + mods[:, 2],
                spray=p[GRAIN_SPRAY.id] + mods[:, 3],
                pan_spread=p[GRAIN_PAN_SPREAD.id] + mods[:, 4],
                position=p[GRAIN_POSITION.id], pos_mod=mods[:, 5],
                step=p[GRAIN_STEP.id], speed_mod=mods[:, 6],
                window_mode=p[GRAIN_WINDOW.id].to(torch.int64),
                direction=p[GRAIN_DIRECTION.id].to(torch.int64),
            )

        # --- allocation, chunk by chunk ------------------------------------
        with tracing.span("granular.alloc"):
            alloc = dict(
                n=cn, sr=sr, frames=frames, loop_range=loop_norm,
                overlap_mode=p[GRAIN_OVERLAP.id][..., 0].to(torch.int64),
                window_table=window_table(dev),
                seed=self.seed ^ (voice_no * 0x51ED),
                max_triggers=max_triggers, max_read_speed=eff_mrs)
            grains = {k: x.flatten(0, 1) for k, x in state["grains"].items()}
            positions = torch.empty((lv, POOL_SIZE, n), dtype=f32, device=dev)
            weights = torch.empty_like(positions)
            pans = []
            for t0 in range(0, n, cn):
                grains, fidx, g = granular_voice_alloc(
                    grains, frame0=frame0 + t0, **alloc,
                    **{k: x[..., t0:t0 + cn] for k, x in per_sample.items()})
                # the read's table is the source extended by one frame each
                # side
                torch.add(fidx, 1.0, out=positions[..., t0:t0 + cn])
                weights[..., t0:t0 + cn] = g
                pans.append(grains["g_pan"])

        with tracing.span("granular.mix"):
            # --- every grain of the block in one read, then the mix ---------
            s = read(positions.view(lv * POOL_SIZE, n)).view(lv, POOL_SIZE, n)
            del positions
            chunks = n // cn

            def by_chunk(x):  # [L*V, P, n] -> [L*V, chunks, P, cn]
                return x.view(lv, POOL_SIZE, chunks, cn).transpose(1, 2)

            audio = grain_mix(by_chunk(s), by_chunk(weights),
                              torch.stack(pans, dim=1))  # [L*V, chunks, 2, cn]
            del s, weights
            audio = audio.transpose(1, 2).reshape(lv, 2, n)

            # voice-level AHDSR after the grain mix (voice.rs:470-486), each
            # sample's note's
            if self.envelope is not None:
                env_p = ahdsr_ops.ahdsr_params(sr, *(first(p[q.id]) for q in (
                    ENV_ATTACK, ENV_HOLD, ENV_DECAY, ENV_SUSTAIN, ENV_RELEASE)))
                env = note_envelope(env_p, age, rel, rels, notes) \
                    * active.to(f32)
            else:
                env = active.to(f32)
            mix = (audio * env[:, None, :]).view(lanes, nv, 2, n).sum(dim=1)
        if ctx.channels == 1:
            mix = ((mix[:, 0] + mix[:, 1]) * 0.5)[:, None]
        elif ctx.channels > 2:
            mix = torch.cat([mix, mix.new_zeros((lanes, ctx.channels - 2, n))],
                            dim=1)
        new_state = dict(state)
        new_state["grains"] = {k: x.view((lanes, nv) + x.shape[1:])
                               for k, x in grains.items()}
        return new_state, mix
