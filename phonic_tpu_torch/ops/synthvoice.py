"""sub3's voice render in two stages around iir2: kernels 10 and 11.

A SynthDef that carries a :class:`SubtractiveVoice` (``SynthDef.kernel``,
which ``synths.sub3`` fills) renders in a SynthGenerator through this
module instead of its own ``render``.  For every voice row (lane-major,
``R = L * V``) and sample of a block:

- stage 10: the sample's note from the row's trigger slots (its age, note,
  velocity, pan, release and glided, speed-automated frequency); the
  modulation matrix's sources and routings; sub3's three detuned morphing
  oscillators (phases summed in float64), its amp AHDSR, the envelope's
  cutoff sweep and the SVF lowpass's coefficients.  Out come iir2's six
  operands, as ``ops/filters.tpt_process`` builds them, and each output
  channel's gain (the envelope, the volume, the velocity, the pan law);
- kernel 2, iir2 (``ops/scan``), runs the SVF's recurrence over the R rows;
- stage 11: each row's lowpass tap ``v2 = (s2' + s2) / 2`` times its gains,
  summed over the V voices of each lane, and the new SVF state.

The generator routes by the device of its tensors:

- CUDA tensors run kernel 10 (:func:`voice_kernel`), iir2 and kernel 11
  (:func:`mix_kernel`) from ``csrc/synthvoice.cu`` (:func:`render_kernels`),
  always, or raise;
- CPU tensors run the plain version (:func:`render_plain`): the note logic
  (:func:`note_logic`), :func:`voice_plain`, the CPU ``linear_recurrence_2``
  and :func:`mix_plain`, which keep the generic path's arithmetic in its
  order (the note logic, ``eval_sources``, ``apply_matrix``, sub3's
  ``render``, gain, pan and ``torch.sum``), so that sub3 renders bit for bit
  as through its own ``render``.

The kernels take each step of the plain version in its order, without FMA
contraction and with the same CUDA math functions, so on the card they
round as the plain version does there but in three places: the phases'
float64 prefix sums (exact at audio increments, whatever the order: the
partial sums of float32 steps fit in a double's 53 bits), the voice sum
(voice order in kernel 11, ``torch.sum``'s order in the plain version), and
the gain, which kernel 10 folds into one factor per output channel where
the plain version multiplies by the envelope, the voice gain and the pan
factor in turn.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import kernels, tracing
from ..modulation import config as mod_cfg
from ..modulation.matrix import (
    apply_matrix, build_source_specs, eval_sources, source_polarity,
)
from . import ahdsr as ahdsr_ops
from . import consts, filters, osc
from .convert import panning_factors
from .precision import recip32
from .scan import iir2, linear_recurrence_2
from .smoothing import SegmentEvents, step_targets

# a synth voice's modulation seed: SEED ^ (0x9E37 * (voice index + 1))
SEED = 0x7157
# kernel 10's source kinds (csrc/synthvoice.cu), the most sources it takes
# and the values per source and lane it reads
_KINDS = {mod_cfg.LfoSource: 0, mod_cfg.EnvelopeSource: 1,
          mod_cfg.VelocitySource: 2, mod_cfg.KeytrackingSource: 3}
MAX_SOURCES = 8
_SOURCE_VALUES = 5
# the trigger slots' and the continuing note's float quantities, in the
# order kernel 10 reads them
TRIG_KEYS = ("note", "vol", "pan", "spd", "rel")
CONT_KEYS = ("active", "note", "vol", "pan", "spd", "rel")
AUTO_KEYS = ("vol", "pan", "spd")


class SubtractiveVoice(NamedTuple):
    """A SynthDef's description for kernels 10 and 11: sub3's voice, three
    detuned morphing oscillators into a resonant SVF lowpass whose cutoff
    the amp envelope sweeps, by the ids of the parameters it reads and its
    amp AHDSR, and the SynthDef ``render`` that it describes: a SynthDef
    whose ``render`` is another (``dataclasses.replace``) keeps that."""

    shape: str  # the morph 0..3 (sine, triangle, saw, square); + modulation
    detune: str  # cents between the oscillators
    cutoff: str  # Hz; modulation scales it by 1 + the offset
    resonance: str  # 0..1
    envelope: tuple  # amp AHDSR: attack, hold, decay (s), sustain, release (s)
    render: Callable  # the SynthDef render this describes

    def describes(self, synth) -> bool:
        """Whether this describes ``synth``'s render."""
        return synth.render is self.render


def voice_seeds(voice_no: torch.Tensor) -> torch.Tensor:
    """Each voice row's modulation seed from its voice number (1-based)."""
    return SEED ^ (0x9E37 * voice_no)


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


class Notes(NamedTuple):
    """Each voice row's note at each sample, ``[R, n]`` each."""

    note: torch.Tensor  # MIDI note
    age: torch.Tensor  # samples since the note started
    velocity: torch.Tensor
    pan: torch.Tensor  # the note's own pan
    release_age: torch.Tensor  # age at note-off (inf = held)
    active: torch.Tensor  # a note sounds on the voice
    freq: torch.Tensor  # Hz, glides and speed automation applied


def note_knots(vs, live, nm: str, n: int) -> torch.Tensor:
    """Per-sample automated values of one note quantity (``vol``, ``pan``
    or ``spd``; stepped or ramped knots, ops/smoothing.step_targets) of each
    row's continuing note and trigger slots: ``[R, K + 1, n]``, the
    continuing note first (reference: fundsp voice set_volume / set_panning
    / set_speed with glide, fundsp/voice.rs:312-380)."""
    rows, k = vs["_trig_time"].shape

    def knots(lane, current, count):
        key = f"_{lane}_{nm}_t"
        ev = SegmentEvents(vs[key].reshape(count, -1).long(),
                           vs[f"_{lane}_{nm}_v"].reshape(count, -1),
                           live[key])
        ramps = vs[f"_{lane}_{nm}_r"].reshape(count, -1)
        return step_targets(current.reshape(-1), ev, ramps, n)[1]

    return torch.cat([knots("ca", vs[f"_cont_{nm}"], rows)[:, None],
                      knots("ta", vs[f"_trig_{nm}"], rows * k).view(rows, k, n)],
                     dim=1)


def note_logic(vs, live, n: int, sr: int, glide_secs: float) -> Notes:
    """Each sample's note on each voice row: the last trigger slot that
    started at or before the sample, else the continuing note."""
    t_time = vs["_trig_time"].contiguous()  # [R, K], sorted, unused at n
    rows, k = t_time.shape
    dev = t_time.device
    f32 = torch.float32
    i = torch.arange(n, dtype=torch.int64, device=dev)
    # each sample's note: 0 the continuing note, j + 1 trigger slot j
    slot = torch.searchsorted(
        t_time, i.to(torch.int32).expand(rows, n).contiguous(), right=True)

    def at(cont, trig):  # [R], [R, K] -> each sample's note's value
        return torch.cat([cont[:, None], trig], dim=1).gather(1, slot)

    def note_value(nm, cont, trig):
        """Each sample's value of one note quantity: its note's automation,
        or the note's constant."""
        if f"_ca_{nm}_t" not in vs:
            return at(cont, trig)
        return note_knots(vs, live, nm, n).gather(1, slot[:, None]).squeeze(1)

    in_b = slot > 0
    c_on = (vs["_cont_active"] > 0.5)[:, None]
    age = i + at(vs["_cont_age0"], -t_time)
    note = at(vs["_cont_note"], vs["_trig_note"])
    vel = note_value("vol", vs["_cont_vol"], vs["_trig_vol"])
    npan = note_value("pan", vs["_cont_pan"], vs["_trig_pan"])
    # speed arrays carry the absolute multiplier (initial
    # 2^((note-60)/12)); normalising by that makes freq_mult == 1
    # exactly when unautomated
    spd = note_value("spd", vs["_cont_spd"], vs["_trig_spd"])
    freq_mult = spd / note_speed(note)
    rel = at(vs["_cont_rel"], vs["_trig_rel"])
    active = in_b | c_on

    if glide_secs > 0.0:
        # exponential-in-pitch glide from the voice's previous note: the
        # continuing one (where it sounds) for the first trigger, the
        # trigger before for each later one
        gsamples = max(glide_secs * sr, 1.0)
        prog = torch.clamp(age.to(f32) * recip32(gsamples), 0.0, 1.0)
        cont_note = vs["_cont_note"]
        prev = at(cont_note, torch.cat([cont_note[:, None],
                                        vs["_trig_note"][:, :-1]], dim=1))
        glides = in_b & (c_on | (slot > 1))
        freq = note_to_hz(torch.where(glides, prev + (note - prev) * prog,
                                      note))
    else:
        freq = note_to_hz(note)
    return Notes(note, age, vel, npan, rel, active, freq * freq_mult)


@functools.lru_cache(maxsize=64)
def _amp_params(sample_rate: int, device: torch.device, envelope: tuple):
    """The amp AHDSR's rates, made once per device (as synths' ``_env``)."""
    p = ahdsr_ops.ahdsr_params(sample_rate, *envelope)
    return ahdsr_ops.AhdsrParams(*(
        consts.const(float(f), torch.float32, device)
        if isinstance(f, torch.Tensor) else f for f in p))


# ---------------------------------------------------------------------------
# The plain version: the generic path's arithmetic in the kernels' stages
# ---------------------------------------------------------------------------

class PlainVoices(NamedTuple):
    """Stage 10's outputs in the plain version: iir2's operands, the new
    phases, and what stage 11 multiplies in, kept apart as the generic path
    rounds them."""

    operands: tuple  # a11, a12, a21, a22, b1, b2, [R, n] each
    phase: torch.Tensor  # [R, 3] the oscillators' phases after the block
    x: torch.Tensor  # [R, n] the oscillators' mix, the SVF's input
    dtype: torch.dtype  # the mix's, which the SVF's output takes
    coefs: filters.TptCoefficients  # the SVF's, its output mix m0..m2
    env: torch.Tensor  # [R, n] the amp envelope
    gain: torch.Tensor  # [R, n] volume x velocity x active
    pan: tuple  # (left, right) [R, n], or () for a mono output


def voice_plain(voice: SubtractiveVoice, phase0, p, notes: Notes, mod,
                voice_no, sr: int, channels: int, volume: str,
                panning: str) -> PlainVoices:
    """Stage 10 after the note logic, in plain PyTorch (the CPU's path, and
    the kernels' reference on the card): the modulation matrix
    (``mod`` = (config, amounts, routings) or None), sub3's render up to
    its SVF's recurrence, and the voices' gains.  ``p`` holds the
    parameters per row ``[R, n]`` (or ``[n]`` for one lane), ``phase0`` the
    phases ``[R, 3]``."""
    note, age, vel, npan, rel, active, freq = notes
    n = freq.shape[-1]
    mods = {}
    if mod is not None:
        config, amounts, routed = mod
        src = eval_sources(build_source_specs(config, p, sr), age, vel, note,
                           rel, n, seed=voice_seeds(voice_no)[:, None])
        m = apply_matrix(src, amounts, routed, source_polarity(config))
        mods = {t: m[:, k] for k, t in enumerate(config.targets)}
    # sub3's render (synths/__init__.py) up to its SVF's recurrence
    shape_v = p[voice.shape]
    if voice.shape in mods:
        shape_v = shape_v + mods[voice.shape]
    det = torch.exp2((p[voice.detune] * recip32(1200.0)).to(
        torch.float64)).to(torch.float32)
    cut_p = p[voice.cutoff]
    if voice.cutoff in mods:
        cut_p = cut_p * (1.0 + mods[voice.cutoff])
    res = p[voice.resonance]
    mix = torch.zeros_like(freq)
    ends = []
    for k, f in enumerate([freq, freq * det, freq / det]):
        ph, end = osc.phase_accumulate(phase0[:, k], f, sr)
        mix = mix + osc.morph_osc(ph, shape_v, f, sr)
        ends.append(end)
    mix = mix * recip32(3.0)
    env = ahdsr_ops.ahdsr_values(_amp_params(sr, age.device, voice.envelope),
                                 1.0, age, rel)
    cut = torch.clamp(cut_p * (0.2 + 0.8 * env), 20.0, sr / 2.0)
    coefs = filters.svf_coefficients(filters.LOWPASS, sr, cut, res)
    # the operands as ops/filters.tpt_process builds them, in float32
    xs = mix.to(torch.float32)
    coefs = filters.TptCoefficients(*(c.to(torch.float32) for c in coefs))
    zeros = torch.zeros_like(xs)
    a1, a2, a3 = coefs.a1, coefs.a2, coefs.a3
    operands = (2.0 * a1 - 1.0, -2.0 * a2 + zeros, 2.0 * a2 + zeros,
                1.0 - 2.0 * a3, 2.0 * a2 * xs, 2.0 * a3 * xs)
    gain = p[volume] * vel * active.to(torch.float32)
    pan = (panning_factors(torch.clamp(p[panning] + npan, -1.0, 1.0))
           if channels >= 2 else ())
    return PlainVoices(operands, torch.stack(ends, dim=-1), xs, mix.dtype,
                       coefs, env, gain, pan)


def mix_plain(voices: PlainVoices, s1, s2, svf: filters.TptState, lanes: int,
              channels: int):
    """Stage 11 in plain PyTorch: the SVF's output from iir2's states ``s1``,
    ``s2`` [R, n] (as ``tpt_process``), the envelope, the voices' gains and
    pan, summed per lane.  Returns (new SVF state, audio [L, ch, n])."""
    v1 = 0.5 * (s1 + filters._prev_seq(s1, svf.ic1.to(torch.float32)))
    v2 = 0.5 * (s2 + filters._prev_seq(s2, svf.ic2.to(torch.float32)))
    c = voices.coefs
    audio = ((c.m0 * voices.x + c.m1 * v1 + c.m2 * v2).to(voices.dtype)
             * voices.env)
    n = audio.shape[-1]
    audio = audio[:, None, :].expand(-1, channels, -1)
    audio = audio.unflatten(0, (lanes, -1))  # [L, V, ch, n]
    audio = audio * voices.gain.view(lanes, -1, 1, n)
    if channels >= 2:
        left, right = voices.pan
        audio = torch.cat([audio[:, :, :1] * left.view(lanes, -1, 1, n),
                           audio[:, :, 1:2] * right.view(lanes, -1, 1, n),
                           audio[:, :, 2:]], dim=2)
    return (filters.TptState(s1[..., -1], s2[..., -1]),
            torch.sum(audio, dim=1))


def render_plain(voice: SubtractiveVoice, state, p, notes: Notes, mod,
                 voice_no, sr: int, lanes: int, channels: int, volume: str,
                 panning: str):
    """The plain version after the note logic: stage 10,
    ``linear_recurrence_2`` (its plain version on the CPU), stage 11.  ``state`` is sub3's per row
    (``phase`` [R, 3], ``svf``).  Returns (new state, audio [L, ch, n])."""
    voices = voice_plain(voice, state["phase"], p, notes, mod, voice_no, sr,
                         channels, volume, panning)
    svf = state["svf"]
    s1, s2 = linear_recurrence_2(*voices.operands,
                                 svf.ic1.to(torch.float32),
                                 svf.ic2.to(torch.float32))
    new_svf, audio = mix_plain(voices, s1, s2, svf, lanes, channels)
    return {"phase": voices.phase, "svf": new_svf}, audio


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

class Slots(NamedTuple):
    """Each voice row's notes as kernel 10 reads them."""

    time: torch.Tensor  # int32 [R, K] the trigger slots' onsets, sorted
    trig: torch.Tensor  # float32 [5, R, K] note, vol, pan, spd, rel
    age0: torch.Tensor  # int32 [R] the continuing note's age at sample 0
    cont: torch.Tensor  # float32 [6, R] active, note, vol, pan, spd, rel
    # float32 [3, R, K + 1, n]: vol, pan and spd per sample (note_knots),
    # where the block carries per-note automation; else None
    automation: Optional[torch.Tensor]


def slot_rows(inputs, live, n: int) -> Slots:
    """Kernel 10's note inputs from a pool's lowered voice arrays
    (``[L, V, ...]``): the rows lane-major, the float quantities stacked,
    and the automation's per-sample values where it has knots."""
    rows = {k: x.flatten(0, 1) for k, x in inputs.items()
            if k.startswith(("_trig_", "_cont_", "_ta_", "_ca_"))}
    automation = None
    if "_ca_vol_t" in rows:
        automation = torch.stack([note_knots(rows, live, nm, n)
                                  for nm in AUTO_KEYS])
    return Slots(rows["_trig_time"].contiguous(),
                 torch.stack([rows[f"_trig_{k}"] for k in TRIG_KEYS]),
                 rows["_cont_age0"].contiguous(),
                 torch.stack([rows[f"_cont_{k}"] for k in CONT_KEYS]),
                 automation)


class Sources(NamedTuple):
    """The modulation matrix as kernel 10 reads it."""

    kinds: tuple  # per source: 0 LFO, 1 envelope, 2 velocity, 3 keytrack
    salts: tuple  # per source: the LFO's seed salt (0x11 x its LFO slot)
    bipolar: tuple  # per source: 1 where it is bipolar
    targets: tuple  # the voice's shape and cutoff targets' indices, or -1
    values: torch.Tensor  # float32 [L, S, 5]: LFO increment; AHDSR rates
    waveforms: torch.Tensor  # int32 [L, S] each LFO's waveform id
    amounts: torch.Tensor  # float32 [L, S, T]
    routed: torch.Tensor  # float32 [L, S, T]: 1 where the routing is bipolar


def sources(voice: SubtractiveVoice, config, params, amounts, routed,
            sr: int) -> Sources:
    """The matrix of ``config`` for kernel 10: the block's first value of
    each source's parameters per lane, through ``build_source_specs`` as
    the plain version takes them (``params`` ``[L, n]``), and the routings
    ``[L, S, T]``."""
    lanes = amounts.shape[0]
    dev = amounts.device
    zero = torch.zeros(lanes, 1, dtype=torch.float32, device=dev)
    no_wave = torch.zeros(lanes, 1, dtype=torch.int32, device=dev)
    values, waves = [], []
    for kind, payload in build_source_specs(config, params, sr):
        wave = no_wave
        if kind == "lfo":
            inc, wave, _ = payload
            vals = [inc] + [zero] * (_SOURCE_VALUES - 1)
        elif kind == "env":
            if payload.attack_scaling != 0.0 or payload.decay_scaling != 0.0:
                raise ValueError("synth voice: kernel 10 takes linear "
                                 "envelope sources")
            vals = list(payload[:_SOURCE_VALUES])
        else:
            vals = [zero] * _SOURCE_VALUES
        values.extend(torch.broadcast_to(v, (lanes, 1)) for v in vals)
        waves.append(torch.broadcast_to(wave, (lanes, 1)))
    salts, lfo = [], 0
    for s in config.sources:
        lfo += isinstance(s, mod_cfg.LfoSource)
        salts.append(0x11 * lfo if isinstance(s, mod_cfg.LfoSource) else 0)
    targets = list(config.targets)
    return Sources(
        tuple(_KINDS[type(s)] for s in config.sources), tuple(salts),
        tuple(int(b) for b in source_polarity(config)),
        tuple(targets.index(t) if t in targets else -1
              for t in (voice.shape, voice.cutoff)),
        torch.cat(values, dim=1).view(lanes, -1, _SOURCE_VALUES),
        torch.cat(waves, dim=1), amounts.contiguous(), routed.contiguous())


class KernelVoices(NamedTuple):
    """Kernel 10's outputs."""

    operands: torch.Tensor  # [6, R, n]: a11, a12, a21, a22, b1, b2
    gains: torch.Tensor  # [G, R, n]: each gain stream (see gain_streams)
    phase: torch.Tensor  # [R, 3] the oscillators' phases after the block


def gain_streams(channels: int) -> int:
    """Kernel 10's gain streams for ``channels`` output channels: the voice
    gain alone (mono); the left and right gains; those and the voice gain
    alone, which channels past the second take unpanned."""
    return min(channels, 3)


def _operand(t: torch.Tensor, what: str, shape, device,
             dtype=torch.float32) -> None:
    kernels.require(t, what, ndim=len(shape), dtype=dtype, device=device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def voice_kernel(voice: SubtractiveVoice, phase0, params, slots: Slots,
                 mod: Optional[Sources], sr: int, glide_secs: float,
                 channels: int, volume: str, panning: str) -> KernelVoices:
    """Kernel 10 (``csrc/synthvoice.cu``): stage 10 of every voice row in
    one launch.  ``phase0`` [R, 3]; ``params`` the voice's and the
    generator's parameters per lane ``[L, n]`` (``volume``, ``panning``:
    their ids); ``slots`` from :func:`slot_rows`; ``mod`` from
    :func:`sources`, or None.  All contiguous CUDA tensors on one card."""
    dev = phase0.device
    kernels.require(phase0, "synth phases", ndim=2, device=dev)
    rows = phase0.shape[0]
    ids = (voice.shape, voice.detune, voice.cutoff, voice.resonance, volume,
           panning)
    for pid in ids:
        kernels.require(params[pid], f"synth parameter {pid}", ndim=2,
                        device=dev)
    lanes, n = params[volume].shape
    for pid in ids:
        _operand(params[pid], f"synth parameter {pid}", (lanes, n), dev)
    if phase0.shape != (rows, 3) or lanes < 1 or rows % lanes or n < 1:
        raise ValueError(f"synth voice: {rows} rows of phases "
                         f"{tuple(phase0.shape)} over {lanes} lanes of {n}")
    kernels.require(slots.time, "synth trigger times", ndim=2,
                    dtype=torch.int32, device=dev)
    k = slots.time.shape[1]
    _operand(slots.time, "synth trigger times", (rows, k), dev, torch.int32)
    _operand(slots.trig, "synth trigger slots", (5, rows, k), dev)
    _operand(slots.age0, "synth note ages", (rows,), dev, torch.int32)
    _operand(slots.cont, "synth continuing notes", (6, rows), dev)
    if slots.automation is not None:
        _operand(slots.automation, "synth note automation",
                 (3, rows, k + 1, n), dev)
    if k < 1:
        raise ValueError("synth voice: no trigger slot")
    # host arrays in the layout phonic_synth_voice (csrc/synthvoice.cu) reads
    cfg_i = np.zeros(11 + 3 * MAX_SOURCES, np.int32)
    pointers = [0, 0, 0, 0]
    if mod is not None:
        s = len(mod.kinds)
        if not 0 < s <= MAX_SOURCES:
            raise ValueError(f"synth voice: {s} modulation sources "
                             f"(1..{MAX_SOURCES})")
        t = mod.amounts.shape[-1]
        _operand(mod.values, "synth source values",
                 (lanes, s, _SOURCE_VALUES), dev)
        _operand(mod.waveforms, "synth LFO waveforms", (lanes, s), dev,
                 torch.int32)
        _operand(mod.amounts, "synth modulation amounts", (lanes, s, t), dev)
        _operand(mod.routed, "synth modulation routings", (lanes, s, t), dev)
        cfg_i[5:9] = (s, t, *mod.targets)
        cfg_i[11:11 + s] = mod.kinds
        cfg_i[11 + MAX_SOURCES:11 + MAX_SOURCES + s] = mod.salts
        cfg_i[11 + 2 * MAX_SOURCES:11 + 2 * MAX_SOURCES + s] = mod.bipolar
        pointers = [x.data_ptr() for x in (mod.values, mod.waveforms,
                                           mod.amounts, mod.routed)]
    else:
        cfg_i[7:9] = -1
    g = gain_streams(channels)
    cfg_i[:5] = (n, k, rows // lanes, lanes, g)
    cfg_i[9:11] = (slots.automation is not None, glide_secs > 0.0)
    amp = _amp_params(sr, torch.device("cpu"), tuple(voice.envelope))
    cfg_f = np.float32([recip32(sr), recip32(max(glide_secs * sr, 1.0)),
                        sr / 2.0] + [float(x) for x in amp[:5]])
    operands = torch.empty(6, rows, n, dtype=torch.float32, device=dev)
    gains = torch.empty(g, rows, n, dtype=torch.float32, device=dev)
    phase = torch.empty_like(phase0)
    auto = slots.automation
    err = kernels.library().phonic_synth_voice(
        dev.index, cfg_i.ctypes.data, cfg_f.ctypes.data,
        slots.time.data_ptr(), slots.trig.data_ptr(), slots.age0.data_ptr(),
        slots.cont.data_ptr(), 0 if auto is None else auto.data_ptr(),
        *(params[pid].data_ptr() for pid in ids), *pointers,
        phase0.data_ptr(), operands.data_ptr(), gains.data_ptr(),
        phase.data_ptr(), kernels.stream_handle(phase0))
    kernels.check(err, "synth_voice")
    tracing.count("kernel.synth_voice")
    voice_kernel.launches += 1
    return KernelVoices(operands, gains, phase)


voice_kernel.launches = 0


def mix_kernel(s1, s2, svf: filters.TptState, gains, lanes: int,
               channels: int):
    """Kernel 11 (``csrc/synthvoice.cu``): stage 11 in one launch, over
    iir2's states ``s1``, ``s2`` [R, n], the SVF state before the block and
    kernel 10's ``gains`` [G, R, n].  Returns (new SVF state, audio
    [L, channels, n])."""
    dev = s2.device
    kernels.require(s2, "synth SVF states", ndim=2, device=dev)
    rows, n = s2.shape
    g = gain_streams(channels)
    _operand(s1, "synth SVF states", (rows, n), dev)
    _operand(svf.ic1, "synth SVF state", (rows,), dev)
    _operand(svf.ic2, "synth SVF state", (rows,), dev)
    _operand(gains, "synth gains", (g, rows, n), dev)
    if lanes < 1 or rows % lanes or n < 1:
        raise ValueError(f"synth mix: {rows} rows over {lanes} lanes")
    audio = torch.empty(lanes, channels, n, dtype=torch.float32, device=dev)
    ic1 = torch.empty_like(svf.ic1)
    ic2 = torch.empty_like(svf.ic2)
    err = kernels.library().phonic_synth_mix(
        dev.index, s1.data_ptr(), s2.data_ptr(), svf.ic1.data_ptr(),
        svf.ic2.data_ptr(), gains.data_ptr(), audio.data_ptr(),
        ic1.data_ptr(), ic2.data_ptr(), lanes, rows // lanes, n, g, channels,
        kernels.stream_handle(s2))
    kernels.check(err, "synth_mix")
    tracing.count("kernel.synth_mix")
    mix_kernel.launches += 1
    return filters.TptState(ic1, ic2), audio


mix_kernel.launches = 0


def render_kernels(voice: SubtractiveVoice, state, params, slots: Slots,
                   mod: Optional[Sources], sr: int, glide_secs: float,
                   channels: int, volume: str, panning: str):
    """Kernels 10, 2 (iir2) and 11 over every voice row.  ``state`` is
    sub3's per row (``phase`` [R, 3], ``svf``).  Returns (new state, audio
    [L, channels, n])."""
    svf = filters.TptState(state["svf"].ic1.contiguous(),
                           state["svf"].ic2.contiguous())
    params = {pid: params[pid].contiguous() for pid in (
        voice.shape, voice.detune, voice.cutoff, voice.resonance, volume,
        panning)}
    voices = voice_kernel(voice, state["phase"].contiguous(), params, slots,
                          mod, sr, glide_secs, channels, volume, panning)
    s1, s2 = iir2(*voices.operands, svf.ic1, svf.ic2)
    lanes = params[volume].shape[0]
    new_svf, audio = mix_kernel(s1, s2, svf, voices.gains, lanes, channels)
    return {"phase": voices.phase, "svf": new_svf}, audio
