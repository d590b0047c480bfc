"""Polyphonic sample-playback generator (port of the sampled path of
``phonic_tpu/generators/sampler.py``).

Behavioural spec: reference src/generator/sampler.rs + sampler/voice.rs —
per-voice chain Panned<Amplified<ChannelMapped<PreloadedFileSource>>> with
AHDSR envelope; effective speed = speed_from_note(note) *
2^(transpose/12 + finetune/1200) (voice.rs:144-157); effective volume =
base * note velocity, panning = clamp(base + note) (voice.rs:158-161);
envelope triggered at full volume (velocity scales the amplifier);
voice stealing free -> longest-releasing -> oldest (sampler.rs:826-860);
FourCC parameters STRN/SFTN/SVOL/SPAN + AHDSR AATK/AHLD/ADCY/ASTN/AREL.

The host-side allocator (a copy of the JAX package's) replays the steal
policy over the scheduled note timeline and lowers each block into
per-voice arrays: one *continuing* note descriptor plus at most one
*retrigger* (steal) descriptor per voice.  ``process`` renders the voices of
a generator pool (graph/batching.LeafBatch) over explicit ``[G, V]``
sampler and voice dimensions: sample positions are float64 cumsums rounded
once to float32, envelopes the closed-form AHDSR (ops/ahdsr.py), so a steal
mid-block is exact — the old note's tail renders up to the trigger, the new
note from it.  The two notes of a voice are live at disjoint samples, so
each voice reads ONE merged position stream, looped or not; the pool reads
every voice of every sampler in one ``ramp_read``.

Known deviations (as in the JAX package): AHDSR parameter changes re-shape
the envelope of already sounding notes analytically; more than one steal of
the same voice within one block keeps only the last note.

Not ported yet: granular playback and the modulation matrix (the granular
slice), and loading a sampler from a file (file decoding).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..events import ParamTimeline
from ..graph.nodes import BuildCtx
from ..io.decoder import AudioFileBuffer
from ..ops import ahdsr as ahdsr_ops
from ..ops import resample as rs
from ..ops.convert import panning_factors
from ..ops.smoothing import SegmentEvents, step_targets
from ..params import (DecibelScaling, ExponentialScaling, FloatParameter,
                      IntegerParameter, format_gain, format_pan)
from .base import Generator, GeneratorPlaybackOptions

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

_GRANULAR_SLICE = ("granular playback and modulation are not ported yet: "
                   "they come with the granular slice (bench.py "
                   "config_granular_1k)")


@dataclasses.dataclass
class AhdsrConfig:
    attack: float = 0.01
    hold: float = 0.0
    decay: float = 0.0
    sustain: float = 1.0
    release: float = 0.05


@dataclasses.dataclass
class _Segment:
    start: int
    note: int
    note_id: int
    volume: float
    panning: float
    release: float = math.inf  # absolute frame of note-off
    cut: float = math.inf  # absolute frame where a steal hard-cuts the voice
    # per-note automation (reference: GeneratorPlaybackEvent::SetVolume /
    # SetPanning / SetSpeed, voice.rs:238-300); created lazily on first event
    vol_tl: object = None
    pan_tl: object = None
    spd_tl: object = None

    def speed0(self) -> float:
        """Note-derived speed multiplier before automation."""
        return 2.0 ** ((self.note - 60) / 12.0)


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
        self._loop_msgs: list = []  # (time, Optional[(start, end)])
        self._plan_cache = None
        self._timelines = {}  # set by the RenderProgram that owns the node

    @property
    def WEIGHT(self):  # reference: weight = active voices (sampler.rs:970)
        return max(self.options.voices, 1)

    @classmethod
    def from_file(cls, path, **kwargs) -> "Sampler":
        raise NotImplementedError(
            "file decoding is not ported yet; build the buffer with "
            "AudioFileBuffer.from_array")

    def source_batch_key(self, ctx):
        """Static-config signature of a generator pool
        (graph/batching.LeafBatch): samplers whose keys match render as one
        pool.  Buffer LENGTH rides in per sampler (``_buf_frames``), so only
        its coarse bucket is in the key; it bounds the zero-padding of a
        pool's buffer table."""
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

    def with_granular_playback(self, config=None) -> "Sampler":
        raise NotImplementedError(_GRANULAR_SLICE)

    def with_modulation(self, config) -> "Sampler":
        raise NotImplementedError(_GRANULAR_SLICE)

    def set_modulation(self, source: str, target: str, amount: float,
                       bipolar: bool = True):
        raise NotImplementedError(_GRANULAR_SLICE)

    def clear_modulation(self, source: str, target: str):
        raise NotImplementedError(_GRANULAR_SLICE)

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

    def param_initials(self):
        env = self.envelope or AhdsrConfig()
        return {TRANSPOSE.id: self.transpose, FINETUNE.id: self.finetune,
                VOLUME.id: self.options.volume, PANNING.id: self.options.panning,
                ENV_ATTACK.id: env.attack, ENV_HOLD.id: env.hold,
                ENV_DECAY.id: env.decay, ENV_SUSTAIN.id: env.sustain,
                ENV_RELEASE.id: env.release}

    # ------------------------------------------------------------------
    # host-side voice allocation (reference steal policy, sampler.rs:826-860)
    # ------------------------------------------------------------------

    def _voice_end(self, seg: _Segment, ctx_sr: int) -> float:
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

    def _allocate(self, sample_rate: int):
        """Replay the event timeline into per-voice segment lists."""
        if self._plan_cache is not None and self._plan_cache[0] == (
            len(self.events), sample_rate
        ):
            return self._plan_cache[1]
        voices: list[list[_Segment]] = [[] for _ in range(self.options.voices)]
        by_id: dict[int, _Segment] = {}
        events = sorted(self.events, key=lambda e: (e.time, e.note_id))
        for ev in events:
            t = ev.time
            if ev.kind == "on":
                # find a free voice, else steal
                idx = None
                for v, segs in enumerate(voices):
                    if not segs or self._voice_end(segs[-1], sample_rate) <= t:
                        idx = v
                        break
                if idx is None:
                    # steal priority (reference sampler.rs:826-860):
                    # a) with an envelope, the longest-releasing voice
                    #    (earliest release start; without an envelope the
                    #    reference never checks the release stage), then
                    # b) the oldest active voice by playback id
                    releasing = [
                        (segs[-1].release, v) for v, segs in enumerate(voices)
                        if segs[-1].release <= t
                    ] if self.envelope is not None else []
                    if releasing:
                        idx = min(releasing)[1]
                    else:
                        idx = min(range(len(voices)),
                                  key=lambda v: voices[v][-1].note_id)
                last = voices[idx][-1] if voices[idx] else None
                if last is not None and self._voice_end(last, sample_rate) > t:
                    last.cut = min(last.cut, t)
                seg = _Segment(t, ev.note, ev.note_id, ev.volume, ev.panning)
                voices[idx].append(seg)
                by_id[ev.note_id] = seg
            elif ev.kind == "off":
                seg = by_id.get(ev.note_id)
                if seg is not None and seg.release is math.inf:
                    seg.release = float(max(t, seg.start))
            elif ev.kind == "all_off":
                for segs in voices:
                    for seg in segs:
                        if seg.start <= t and seg.release is math.inf:
                            seg.release = float(t)
            elif ev.kind in ("set_vol", "set_pan", "set_spd"):
                seg = by_id.get(ev.note_id)
                if seg is None or t < seg.start:
                    continue
                if ev.kind == "set_vol":
                    if seg.vol_tl is None:
                        seg.vol_tl = ParamTimeline(initial=seg.volume)
                    seg.vol_tl.set_at(t, ev.value)
                elif ev.kind == "set_pan":
                    if seg.pan_tl is None:
                        seg.pan_tl = ParamTimeline(initial=seg.panning)
                    seg.pan_tl.set_at(t, ev.value)
                else:
                    if seg.spd_tl is None:
                        seg.spd_tl = ParamTimeline(initial=seg.speed0())
                    if ev.glide and ev.glide > 0.0:
                        seg.spd_tl.set_glide_at(t, ev.value, ev.glide,
                                                sample_rate)
                    else:
                        seg.spd_tl.set_at(t, ev.value)
        self._plan_cache = ((len(self.events), sample_rate), voices)
        return voices

    def prepare(self, ctx: BuildCtx) -> None:
        # the engine hands us the output rate at program build so lowering
        # never falls back to a default
        self._sr = ctx.sample_rate

    def _max_step_bound(self, voices) -> float:
        """Upper bound on any voice's per-sample read step: max note pitch
        over every allocated segment (incl. set_note_speed automation knots)
        x the transpose/finetune parameter bound x the rate ratio."""
        def tl_max(pid, initial):
            tl = self._timelines.get(pid)
            vals = [float(initial)]
            if tl is not None:
                vals.append(tl.initial)
                vals.extend(tl.values)
            return max(vals)

        pitch = 2.0 ** (tl_max(TRANSPOSE.id, self.transpose) / 12.0
                        + tl_max(FINETUNE.id, self.finetune) / 1200.0)
        spd = 1.0
        for segs in voices:
            for seg in segs:
                spd = max(spd, seg.speed0())
                if seg.spd_tl is not None and seg.spd_tl.values:
                    spd = max(spd, max(seg.spd_tl.values))
        return pitch * spd * (self.buffer.sample_rate / self._sr)

    def lower_block_inputs(self, block_start: int, block_len: int):
        """The block's voice arrays, equal to the JAX package's lowering
        except for the read-window tag: ``_smax`` is the step bound
        2**bucket (monotone over the program's life) itself."""
        if not hasattr(self, "_sr"):
            raise RuntimeError(
                f"{type(self).__name__} lowered before prepare(); the node "
                "must be part of a RenderProgram")
        voices = self._allocate(self._sr)
        v = self.options.voices
        out = {
            "_cont_active": np.zeros(v, np.float32),
            "_cont_note": np.full(v, 60.0, np.float32),
            "_cont_vol": np.zeros(v, np.float32),
            "_cont_pan": np.zeros(v, np.float32),
            "_cont_age0": np.zeros(v, np.int32),
            "_cont_rel": np.full(v, np.inf, np.float32),
            "_cont_spd": np.ones(v, np.float32),
            "_trig_time": np.full(v, block_len, np.int32),
            "_trig_note": np.full(v, 60.0, np.float32),
            "_trig_vol": np.zeros(v, np.float32),
            "_trig_pan": np.zeros(v, np.float32),
            "_trig_rel": np.full(v, np.inf, np.float32),
            "_trig_spd": np.ones(v, np.float32),
        }
        # Per-note automation events per lane (cont "ca" / trig "ta"), K
        # knots per block so speed-glide ramps lower losslessly; emitted
        # only once ANY per-note automation exists
        has_auto = any(ev.kind.startswith("set_") for ev in self.events)
        ka = max(4, block_len // 512)
        if has_auto:
            for lane in ("ca", "ta"):
                for nm in ("vol", "pan", "spd"):
                    out[f"_{lane}_{nm}_t"] = np.full((v, ka), block_len,
                                                     np.int32)
                    out[f"_{lane}_{nm}_v"] = np.zeros((v, ka), np.float32)
                    out[f"_{lane}_{nm}_r"] = np.zeros((v, ka), np.float32)

        def _lower_auto(seg, lane, vi):
            if not has_auto:
                return
            for nm, tl in (("vol", seg.vol_tl), ("pan", seg.pan_tl),
                           ("spd", seg.spd_tl)):
                if tl is not None:
                    t_, v_, r_ = tl.lower_block(block_start, block_len, ka)
                    out[f"_{lane}_{nm}_t"][vi] = t_
                    out[f"_{lane}_{nm}_v"][vi] = v_
                    out[f"_{lane}_{nm}_r"][vi] = r_
        # step bound (monotone: a shrinking bound would change the clamp
        # mid-note)
        b = rs.speed_bucket(self._max_step_bound(voices))
        self._spd_bucket = max(b, getattr(self, "_spd_bucket", 0))
        out["_smax"] = np.float32(2.0 ** self._spd_bucket)
        # _loop_* inputs exist only when looping can engage (_can_loop)
        if self._can_loop():
            rng = self._loop_at(block_start)
            out["_loop_on"] = np.float32(0.0 if rng is None else 1.0)
            out["_loop_start"] = np.float32(0.0 if rng is None else rng[0])
            out["_loop_end"] = np.float32(
                self.buffer.frames if rng is None else rng[1])
        # live buffer length: samplers of one pool pad to its longest
        out["_buf_frames"] = np.float32(self.buffer.frames)
        for vi, segs in enumerate(voices):
            cont = None
            trig = None
            for seg in segs:
                if seg.start < block_start and max(seg.cut, seg.start) > block_start:
                    cont = seg
                elif block_start <= seg.start < block_start + block_len:
                    trig = seg  # keep the last
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
                # a cut without retrigger in this block: emulate via trig_time
                if cont.cut is not math.inf and cont.cut < block_start + block_len and trig is None:
                    out["_trig_time"][vi] = int(cont.cut) - block_start
            if trig is not None:
                out["_trig_time"][vi] = trig.start - block_start
                out["_trig_note"][vi] = trig.note
                out["_trig_vol"][vi] = trig.volume
                out["_trig_pan"][vi] = trig.panning
                out["_trig_spd"][vi] = trig.speed0()
                if trig.release is not math.inf:
                    out["_trig_rel"][vi] = trig.release - trig.start
                _lower_auto(trig, "ta", vi)
        return out

    # ------------------------------------------------------------------
    # device-side rendering
    # ------------------------------------------------------------------

    def init_state(self, ctx: BuildCtx):
        """Each voice's carried read position ``base + frac``; the sample
        data lives in the pool's buffer table (graph/batching.LeafBatch)."""
        self._sr = ctx.sample_rate
        v = self.options.voices
        return {"base": torch.zeros(v, dtype=torch.int32, device=ctx.device),
                "frac": torch.zeros(v, dtype=torch.float32, device=ctx.device)}

    def process(self, state, params, voices, smax: float, live: dict,
                read, ctx: BuildCtx):
        """Render the V voices of G samplers that share this sampler's
        ``source_batch_key`` (a generator pool).

        state: {"base", "frac"} [G, V]; params: each parameter [G, n];
        voices: the lowered arrays as tensors, [G] per sampler, [G, V] per
        voice, [G, V, K] per automation knot; smax: the pool's step bound;
        live: per automation ``_t`` key, the segments that can start in the
        block (host-known, see ops/smoothing.SegmentEvents); read: positions
        [G*V, n] -> audio [G*V, ch, n], the pool's one read.
        Returns (new state, audio [G, ch, n])."""
        n = ctx.block_frames
        g, v = state["base"].shape
        dev = state["base"].device
        ratio = float(np.float32(self.buffer.sample_rate / ctx.sample_rate))
        ii = torch.arange(n, dtype=torch.int32, device=dev)

        def per_sampler(x):  # [G] -> [G, 1, 1]
            return x[:, None, None]

        def per_voice(k):  # [G, V] -> [G, V, 1]
            return voices[k][..., None]

        pitch = torch.exp2(params[TRANSPOSE.id] / 12.0
                           + params[FINETUNE.id] / 1200.0)[:, None, :]  # [G, 1, n]

        def auto(lane, nm, current):
            """Per-sample automated value of one descriptor (stepped or ramped
            knots, ops/smoothing.step_targets), or the block's constant."""
            key = f"_{lane}_{nm}_t"
            if key not in voices:
                return current[..., None]
            ev = SegmentEvents(voices[key].reshape(g * v, -1).long(),
                               voices[f"_{lane}_{nm}_v"].reshape(g * v, -1),
                               live[key])
            ramps = voices[f"_{lane}_{nm}_r"].reshape(g * v, -1)
            return step_targets(current.reshape(-1), ev, ramps, n)[1].reshape(
                g, v, n)

        def positions(spd, mask):
            """Read steps and their running sum: the sum in float64, rounded
            once, so that it does not depend on the device's order of
            summation."""
            # the JAX package's windowed reads need steps <= smax (never
            # binds in-bucket); clamping here keeps the positions equal
            speed = torch.clamp(pitch * spd * ratio, max=smax)
            steps = torch.where(mask, speed, 0.0)
            run = torch.cumsum(steps.to(torch.float64), dim=-1).to(torch.float32)
            return steps, run, torch.cat(
                [torch.zeros_like(run[..., :1]), run[..., :-1]], dim=-1)

        t_time = voices["_trig_time"]
        in_b = ii >= t_time[..., None]  # [G, V, n]: the retriggered note
        switch = (t_time < n) & (voices["_trig_vol"] > 0.0)  # [G, V]
        mask_a = (voices["_cont_active"] > 0.5)[..., None] & ~in_b
        mask_b = in_b & switch[..., None]

        # note A continues from the carried position; note B starts at 0
        steps_a, _, rel_a = positions(auto("ca", "spd", voices["_cont_spd"]),
                                      mask_a)
        pos_a = (state["base"].to(torch.float32) + state["frac"])[..., None] + rel_a
        steps_b, run_b, pos_b = positions(auto("ta", "spd", voices["_trig_spd"]),
                                          mask_b)
        end_pos = torch.where(switch, run_b[..., -1],
                              pos_a[..., -1] + steps_a[..., -1])
        new_base = torch.floor(end_pos)

        # one merged stream per voice: the notes are live at disjoint samples
        pos = torch.where(in_b & switch[..., None], pos_b, pos_a)
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
        mask = torch.where(in_b, mask_b, mask_a) & live_pos
        audio = read(pos.reshape(g * v, n)).reshape(g, v, -1, n)

        # the note each sample belongs to: age, note-off run, volume, pan
        ages = torch.where(in_b, ii - t_time[..., None],
                           per_voice("_cont_age0") + ii)
        rel = torch.where(in_b, per_voice("_trig_rel"), per_voice("_cont_rel"))
        if self.envelope is not None:
            env_p = ahdsr_ops.ahdsr_params(
                ctx.sample_rate, *(per_sampler(params[p.id][:, 0]) for p in (
                    ENV_ATTACK, ENV_HOLD, ENV_DECAY, ENV_SUSTAIN, ENV_RELEASE)))
            level = torch.where(
                in_b, ahdsr_ops.release_level(env_p, 1.0, per_voice("_trig_rel")),
                ahdsr_ops.release_level(env_p, 1.0, per_voice("_cont_rel")))
            env = ahdsr_ops.ahdsr_values(env_p, 1.0, ages, rel, level)
        else:
            # one-shot: the de-click fade after note-off
            fade_log1m = math.log1p(-(1.0 - math.exp(
                -1.0 / max(ctx.sample_rate * self.options.fade_out_secs
                           / math.log(100.0), 1e-9))))
            agef = ages.to(torch.float32)
            down = torch.exp(fade_log1m * torch.clamp(agef - rel + 1.0, min=0.0))
            env = torch.where(agef < rel, 1.0,
                              torch.where(down < 1e-4, 0.0, down))
        vol = torch.where(in_b, auto("ta", "vol", voices["_trig_vol"]),
                          auto("ca", "vol", voices["_cont_vol"]))
        pan = torch.where(in_b, auto("ta", "pan", voices["_trig_pan"]),
                          auto("ca", "pan", voices["_cont_pan"]))
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
