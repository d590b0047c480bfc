"""The plain reference of a polyphonic subtractive synth: upstream's
src/generator/fundsp.rs (a voice graph per voice, note events placed with
the sampler's steal policy, user parameters and a modulation matrix)
playing examples/common/synths/sub3.rs: three detuned morphing oscillators
into a resonant state-variable lowpass, an AHDSR on the amplitude that also
sweeps the cutoff.

Written from the synth's documented behaviour, in plain PyTorch; it imports
nothing of the program under test.  Per lane, the sampler reference's
allocator (``reference/sampler.py``, shared) takes the note events in time
order and places each note on a voice: the lowest free voice, else the
voice with the oldest note (a synth has no release stage to prefer).  A
voice is free ``release_secs * rate + 1`` frames after its note's note-off,
or where the next note on it starts.  Every voice renders every sample: at
each sample its note is the last one that started on it at or before the
sample (the *continuing* note, from an earlier block, where none started
in the block).  The note gives the sample its age, pitch, velocity and
release; the voice's three oscillator phases and its filter state run on
through every note it plays.

The patch: shape ``SHAP`` (plus the modulation) morphs each oscillator from
a sine (0) through a triangle (1) and a polyBLEP saw (2) to a polyBLEP
square (3), whose residual at a step of the wave is the standard two-sample
one: ``-(1 - x)^2`` at ``x = t / dt`` in the sample step after it and
``(1 + x)^2`` at ``x = (t - 1) / dt`` in the step before it; the
oscillators sit at the note's frequency and ``DETN`` cents
above and below it; their mean goes through the SVF lowpass, cutoff ``CUTF
* (1 + modulation) * (0.2 + 0.8 * amp envelope)`` (within 20 Hz and half
the rate), damping ``max(2 * (1 - 0.97 * RESO), 0.03)``, then times the
amp envelope, the note's velocity and ``SVOL``, panned by ``SPAN`` (the
constant-power law, unity at the centre).  The modulation matrix's
sources restart at each note: an LFO's phase is the note's age times its
rate, an envelope source runs from the note's start to its velocity as
level, the velocity source is the note's velocity.  Each routing adds its
source (made bipolar or unipolar as the routing says) times its amount.

Departures from upstream, each a choice the engine documents:

* the envelopes are the closed form of upstream's AHDSR stage machine with
  linear curves (``reference/sampler.py`` says the same of its envelope);
  an envelope source attacks towards the velocity at the envelope's own
  rate and decays at ``(1 - sustain)`` per decay time;
* a voice that has never played renders note 60 at velocity 0, silent, its
  envelopes restarting at each block; a voice whose note has ended keeps
  that note's pitch and ages: both only set the state the voice's next
  note starts from;
* oscillator phases follow the engine's float32 definition, since a phase
  decides on which side of an edge of the wave a sample lands: each note's
  frequency is ``440 * 2^((note - 69) / 12)`` (float64 ``exp2`` of a
  float32 exponent, rounded once) in float32, its detuned copies the
  float32 product and quotient with ``2^(DETN / 1200)`` (likewise), a
  sample's phase step the float32 product with the float32 reciprocal of
  the rate; the steps are summed in float64 from the phase carried in
  float32 from the block before and the phase is rounded once to float32;
  the polyBLEP's and the square's choices of branch are taken on those
  float32 phases and steps;
* the counts of an envelope's attack and hold runs are taken as the engine
  counts them, from float32 rates.

Every audio value is computed in ``dtype``.  ``SVOL``, ``SPAN``, ``CUTF``
and ``RESO`` follow the engine's exponential smoother (``params.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dsp
from .params import Param
from .sampler import SamplerReference

F32 = torch.float32
f32 = np.float32
SILENCE = 0.001  # a release snaps to 0 below -60 dB


class _Voices(list):
    """A lane's voices as the shared allocator sees them (each voice's
    latest note); it also keeps every note placed on each voice."""

    def __init__(self, voices: int):
        super().__init__([None] * voices)
        self.placed = [[] for _ in range(voices)]

    def __setitem__(self, v, note):
        super().__setitem__(v, note)
        self.placed[v].append(note)


def note_hz(note: int) -> float:
    """A note's float32 frequency (module docstring)."""
    e = f32(f32(note - 69) * (f32(1.0) / f32(12.0)))
    return float(f32(440.0) * f32(np.exp2(np.float64(e))))


def runs(level, rate) -> int:
    """The runs a stage lasts that climbs to ``level`` at ``rate`` a run,
    counted in float32 as the engine counts them."""
    return math.ceil(f32(level) / f32(rate)) if rate > 0 else 0


class Envelope:
    """An AHDSR (seconds, sustain level) at ``sr``: the engine's float32
    stage rates, for the run counts."""

    def __init__(self, attack, hold, decay, sustain, release, sr: int):
        self.a, self.d = attack, decay
        self.s, self.r, self.sr = sustain, release, sr
        self.attack_rate = (f32(1.0) / (f32(attack) * f32(sr))
                            if attack > 0 else 0.0)
        self.hold_runs = math.ceil(f32(hold) * f32(sr))

    def attack_runs(self, level) -> int:
        return runs(level, self.attack_rate)

    def values(self, c, level, a_runs, rel_at):
        """The envelope at run ``c`` (age + 1) of notes at ``level`` whose
        attacks last ``a_runs`` runs, released after run ``rel_at``."""
        sr, s = self.sr, self.s

        def held(c):
            attack = torch.minimum(c / (self.a * sr), level)
            toward = torch.where(level > s, -1.0, 1.0)
            decay = level + toward * (1.0 - s) / (self.d * sr) * (
                c - a_runs - self.hold_runs)
            decay = torch.where(level > s, torch.clamp(decay, min=s),
                                torch.clamp(decay, max=s))
            return torch.where(c <= a_runs, attack,
                               torch.where(c <= a_runs + self.hold_runs,
                                           level, decay))

        at_off = held(torch.clamp(rel_at, min=1.0).nan_to_num(posinf=1.0))
        at_off = torch.where(rel_at >= 1.0, at_off, 0.0)
        rel = at_off * (1.0 - (c - rel_at) / (self.r * sr))
        rel = torch.where((rel <= SILENCE) | (at_off <= dsp.F32_EPS), 0.0, rel)
        return torch.where(c > rel_at, rel, held(c))


def _wrap(x64: torch.Tensor) -> torch.Tensor:
    """A float64 phase's fractional part, rounded once to float32."""
    frac = (x64 - torch.floor(x64)).to(F32)
    return torch.where(frac >= 1.0, frac - 1.0, frac)


def _polyblep(t, dt, dtype):
    """The standard polyBLEP residual at float32 phases ``t`` and steps
    ``dt``, its branch taken in float32, its value in ``dtype``: -1 at the
    wrap rising to 0 one step after it, 0 one step before it rising to 1 at
    the wrap."""
    dt = torch.clamp(dt, min=1e-9)
    after = t.to(dtype) / dt.to(dtype)  # in [0, 1) just after the wrap
    before = (t.to(dtype) - 1.0) / dt.to(dtype)  # in (-1, 0) just before
    return torch.where(t < dt, -(1.0 - after) ** 2,
                       torch.where(t > 1.0 - dt, (1.0 + before) ** 2, 0.0))


def morph(phase, dt, shape, dtype):
    """The morphing oscillator at float32 ``phase`` with float32 step
    ``dt``: shape 0..3 crossfades sine, triangle, saw, square."""
    p = phase.to(dtype)
    sine = torch.sin(2.0 * math.pi * p)
    tri = torch.where(p < 0.25, 4.0 * p,
                      torch.where(p < 0.75, 2.0 - 4.0 * p, 4.0 * p - 4.0))
    saw = 2.0 * p - 1.0 - _polyblep(phase, dt, dtype)
    t2 = torch.remainder(phase - 0.5, 1.0)
    square = (torch.where(phase < 0.5, 1.0, -1.0).to(dtype)
              + _polyblep(phase, dt, dtype) - _polyblep(t2, dt, dtype))
    shape = torch.clamp(shape, 0.0, 3.0)
    lo = torch.clamp(torch.floor(shape), 0.0, 2.0)
    frac = shape - lo
    waves = (sine, tri, saw, square)

    def wave(k):
        out = torch.zeros_like(p)
        for j, w in enumerate(waves):
            out = torch.where(k == j, w, out)
        return out
    return wave(lo) * (1.0 - frac) + wave(lo + 1.0) * frac


def svf_lowpass(sr: int, cutoff, resonance):
    """The SVF lowpass's TPT coefficients (a1, a2, a3, m0, m1, m2)."""
    g = torch.tan(math.pi * cutoff / sr)
    k = torch.clamp(2.0 * (1.0 - resonance * 0.97), min=0.03)
    a1 = 1.0 / (1.0 + g * (g + k))
    a2 = g * a1
    a3 = g * a2
    zero = torch.zeros_like(g)
    return a1, a2, a3, zero, zero, zero + 1.0


class SynthReference(SamplerReference):
    """``lanes`` independent synth generators of ``voices`` voices at
    ``sample_rate``, stereo, one block of ``block_frames`` at a time.

    ``patch``: ``shape``, ``detune_cents``, ``cutoff``, ``resonance`` and
    ``envelope`` (the amp AHDSR: attack, hold, decay, sustain, release);
    ``modulation``: its ``sources`` (``{"kind": "lfo", "id", "rate"}`` with a
    sine waveform, ``{"kind": "envelope", "id", "attack", "hold", "decay",
    "sustain", "release"}``, ``{"kind": "velocity", "id"}``) and
    ``routings`` (``[source id, target, amount, bipolar]``, targets
    ``CUTF`` and ``SHAP``)."""

    def __init__(self, lanes: int, sample_rate: int, block_frames: int,
                 voices: int, patch: dict, modulation: dict, device,
                 dtype=torch.float64, volume: float = 1.0,
                 release_secs: float = 0.2):
        # no product of the render may run in TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.sr, self.lanes, self.n, self.voices = (sample_rate, lanes,
                                                    block_frames, voices)
        self.env = None  # the allocator steals the oldest voice
        self.release_secs = release_secs
        self.dev, self.dt = device, dtype
        self.patch, self.mod = patch, modulation
        self.amp = Envelope(*patch["envelope"], sample_rate)
        self.params = {
            "SVOL": Param(volume, "exp", lanes, device, dtype, sample_rate),
            "SPAN": Param(0.0, "exp", lanes, device, dtype, sample_rate),
            "CUTF": Param(patch["cutoff"], "exp", lanes, device, dtype,
                          sample_rate),
            "RESO": Param(patch["resonance"], "exp", lanes, device, dtype,
                          sample_rate)}
        self.queue = [[] for _ in range(lanes)]
        self.slots = [_Voices(voices) for _ in range(lanes)]
        self.notes = [[] for _ in range(lanes)]
        self.order = 0
        self.block_index = 0
        # each voice's oscillator phases (float32) and filter state
        self.phase = torch.zeros((lanes, voices, 3), dtype=F32, device=device)
        self.svf = [(torch.zeros(voices, dtype=dtype, device=device),
                     torch.zeros(voices, dtype=dtype, device=device))
                    for _ in range(lanes)]
        self.det = f32(np.exp2(np.float64(f32(f32(patch["detune_cents"])
                                              * (f32(1.0) / f32(1200.0))))))
        self.envs = {s["id"]: Envelope(s["attack"], s["hold"], s["decay"],
                                       s["sustain"], s["release"], sample_rate)
                     for s in modulation["sources"]
                     if s["kind"] == "envelope"}

    def _free_at(self, nt) -> float:
        return min(nt.release + self.release_secs * self.sr + 1, nt.cut)

    def step(self) -> torch.Tensor:
        """The next block of every lane: [lanes, 2, n]."""
        n = self.n
        bs = self.block_index * n
        pv = {k: p.block(n, self.sr) for k, p in self.params.items()}
        out = torch.zeros((self.lanes, 2, n), dtype=self.dt, device=self.dev)
        for lane in range(self.lanes):
            self._allocate(lane, bs + n)
            self.notes[lane] = []  # every note that can still sound is a slot
            out[lane] = self._render(lane, {k: v[lane] for k, v in pv.items()},
                                     bs)
        self.block_index += 1
        return out

    def _segments(self, lane: int, bs: int):
        """Per voice, the notes that sound in the block: the continuing
        note (or None) and the notes that start in it."""
        voices = self.slots[lane].placed
        out = []
        for v, placed in enumerate(voices):
            before = [nt for nt in placed if nt.start < bs]
            cont = before[-1] if before and before[-1].cut > bs else None
            out.append([cont] + [nt for nt in placed if nt.start >= bs])
            voices[v] = placed[-1:]
        return out

    def _render(self, lane: int, pv: dict, bs: int) -> torch.Tensor:
        n, dt, dev, sr = self.n, self.dt, self.dev, self.sr
        segs = self._segments(lane, bs)
        k = max(len(s) for s in segs) + 1  # a column past the last start

        def at(fn, idle, dtype):
            """Each sample's note's value ``fn(note)`` [V, n] (``idle``
            where the voice has no note)."""
            rows = [[idle if nt is None else fn(nt) for nt in s]
                    + [idle] * (k - len(s)) for s in segs]
            return torch.tensor(rows, dtype=dtype, device=dev).gather(1, seg)

        starts = torch.tensor([[nt.start - bs for nt in s[1:]]
                               + [n] * (k - len(s)) for s in segs],
                              dtype=torch.int64, device=dev)
        i = torch.arange(n, device=dev)
        seg = torch.searchsorted(starts, i.expand(len(segs), n).contiguous(),
                                 right=True)  # [V, n]: 0 the continuing note

        age = (i + at(lambda nt: bs - nt.start, 0, torch.int64)).to(dt)
        c = age + 1.0
        vel = at(lambda nt: float(f32(nt.vel)), 0.0, dt)
        rel_at = at(lambda nt: nt.release - nt.start, math.inf, dt)
        sounding = at(lambda nt: 1.0, 0.0, dt)
        pan = at(lambda nt: float(f32(nt.pan)), 0.0, dt)
        # each oscillator's float32 phase step (module docstring)
        r_sr = f32(1.0) / f32(sr)

        def steps(note):
            hz = f32(note_hz(note))
            return [float(f32(h) * r_sr) for h in (
                hz, f32(hz * self.det), f32(hz / self.det))]
        table = [at(lambda nt, j=j: steps(nt.note)[j], steps(60)[j], F32)
                 for j in range(3)]

        # the modulation matrix
        mods = {"CUTF": torch.zeros_like(age), "SHAP": torch.zeros_like(age)}
        src = {}
        for s in self.mod["sources"]:
            if s["kind"] == "lfo":
                if s.get("waveform", "Sine") != "Sine":
                    raise ValueError("the reference's LFO is a sine")
                ph = torch.remainder(age * s["rate"] / sr, 1.0)
                src[s["id"]] = (dsp.sine_approx(torch.where(
                    ph < 0.5, ph, ph - 1.0) * (2.0 * math.pi)), True)
            elif s["kind"] == "envelope":
                e = self.envs[s["id"]]
                a_runs = at(lambda nt: e.attack_runs(f32(nt.vel)), 0, dt)
                src[s["id"]] = (e.values(c, vel, a_runs, rel_at), False)
            else:
                src[s["id"]] = (vel, False)
        for sid, target, amount, bipolar in self.mod["routings"]:
            x, src_bip = src[sid]
            if src_bip and not bipolar:
                x = (x + 1.0) * 0.5
            elif bipolar and not src_bip:
                x = (x - 0.5) * 2.0
            mods[target] = mods[target] + x * amount

        # the oscillators: float32 steps summed in float64
        shape = self.patch["shape"] + mods["SHAP"]
        mix = torch.zeros_like(age)
        ends = []
        for j, step in enumerate(table):
            run = torch.cumsum(step.double(), dim=-1)
            p0 = self.phase[lane, :, j].double()
            phase = _wrap(p0[:, None] + (run - step.double()))
            ends.append(_wrap(p0 + run[:, -1]))
            mix = mix + morph(phase, step, shape, dt)
        self.phase[lane] = torch.stack(ends, dim=-1)
        mix = mix / 3.0

        # the amp envelope, the cutoff it sweeps and the filter
        env = self.amp.values(c, torch.ones_like(c), self.amp.attack_runs(1.0),
                              rel_at)
        cut = torch.clamp(pv["CUTF"] * (1.0 + mods["CUTF"]) * (0.2 + 0.8 * env),
                          20.0, sr / 2.0)
        coefs = svf_lowpass(sr, cut, pv["RESO"])
        self.svf[lane], y = dsp.tpt(self.svf[lane], mix, *coefs)
        voice = y * env * vel * sounding * pv["SVOL"]
        left, right = dsp.pan_gains(pv["SPAN"] + pan)
        return torch.stack([(voice * left).sum(dim=0),
                            (voice * right).sum(dim=0)])
