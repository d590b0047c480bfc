"""The plain reference of a granular sampler: upstream's
src/generator/sampler/granular.rs, each voice of a polyphonic sampler
(src/generator/sampler.rs, its steal policy and AHDSR) a pool of 100
grains (sampler/voice.rs) in Cloud mode, with the sampler's stock
modulation matrix (LFO1, LFO2, velocity and key tracking into the
granular parameters, sampler.rs:362-427), reading the sample monoized and
resampled to the output rate (sampler.rs:908-952).

Written from upstream's description, in plain PyTorch; it imports nothing
of the program under test.  Per lane, the sampler reference's allocator
(``reference/sampler.py``, shared) places each note on a voice: the lowest
free voice, else the one released earliest, else the oldest; a voice is
free ``0.999 * release * rate + 1`` frames after its note-off.  At each
sample a voice plays the last note that started on it at or before the
sample.  While a note holds the voice:

* a density phase accumulator advances by ``density / rate`` a sample; a
  grain is triggered where it crosses a whole number, and at the note's
  start, where upstream's start() arms it at 1.0 (granular.rs:484,
  788-809), as long as the note is held (before its note-off);
* a note's start resets the voice's pool bookkeeping: the phase arms, the
  playhead moves to the position and leaves the loop, and the grains of
  earlier notes stop there;
* the playhead advances by ``step * (1 + modulation) / file length`` a
  sample, wrapping, with the loop-entry latch (granular.rs:605-640);
* each trigger takes the first free slot (granular.rs:823) and draws
  7 numbers: the volume ``1 - variation * u``, two pitch offsets of up to
  half a semitone times the variation, the size ``(1 - 0.75 var) + 2.75
  var * u`` times the grain size, the pan ``pan + spread * r``, the
  direction and the spray ``spray * r`` seconds around the position
  (granular.rs:813-897);
* a grain plays ``size`` frames of the window (a 2048-entry LUT read
  with a linear interpolation, granular.rs:112-215) times its volume at
  positions ``pos0 + age * speed / file length`` on the file's circle,
  read with the 4-point Catmull-Rom interpolation and circular taps
  (granular.rs:899-933), panned by the linear law ``((1 - p) / 2, (1 + p)
  / 2)`` (granular.rs:933-941);
* the voice's grains are summed and shaped by the voice's AHDSR
  (voice.rs:470-486), the closed form of ``reference/sampler.py``.

Modulation: LFO1 and LFO2 are the stock 1 Hz and 2 Hz sines of upstream's
LFO (its parabolic sine, src/utils/dsp/lfo.rs:7-19) restarting at each
note, the velocity and the key (note / 127) unipolar; each routing adds its
source, made bipolar or unipolar as the routing says, times its amount.
The sample is the stereo table averaged to mono and resampled by the
4-point Catmull-Rom interpolation to the output rate.

Departures from upstream, each one the engine's and stated by it:

* the 2048-frame allocation chunk: a block longer than 2048 frames (and a
  multiple of it) allocates in chunks of 2048, and a slot is reusable only
  if its grain ended before the chunk; a chunk takes at most ``ceil(100 Hz
  * chunk) + 2`` triggers per voice, the earliest (with at most two note
  starts on a voice in a chunk the bound is never reached);
* the loop-entry latch is evaluated per chunk: the playhead folds into the
  loop from the first sample of the chunk that lies in it (with at most one
  pass through the loop per chunk, the same);
* the ``max_read_speed`` cap: a grain's speed is clamped to it (4 by
  default), where upstream has none;
* the counter-hash draws: the 7 numbers of a trigger are the uniform
  ``[-1, 1)`` float32 values of a splitmix-style 32-bit hash of the voice's
  seed and the counter ``trigger * 8 + i`` (``i`` in 0-6), the voice's
  ``trigger`` counting the triggers it took; upstream draws from an
  OS-seeded generator;
* a voice's phase that a start armed stays armed until the note is held.

The engine's float32 definition is followed where a decision or a read
position depends on it (a position's float32 rounding is 1/32 of a frame
at the end of a 10 s table): the trigger phase and the playhead are summed
in float64 from the note's start (or the carried value) and rounded once to
float32; the LFOs' phases and parabolic sine, the matrix and the granular
parameters they modulate are float32; a grain's duration is the float32
product ``size * scale * (rate / 1000)`` truncated; its pitch is ``exp2`` of
the float32 semitones over 12, evaluated in float64 and rounded once; its
start position, its position at each age and its volume scale are fused
multiply-adds rounded once to float32, its increment the float32 product.
Every audio value (the window, the read, the volumes, pans, envelope and
sums) is computed in ``dtype``.  ``SVOL`` and ``SPAN`` follow the engine's
exponential smoother, ``GPOS``, ``GSIZ`` and ``GDEN`` step at their events
(``params.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import dsp
from .params import Param
from .sampler import SamplerReference
from .synth import _Voices

F32 = torch.float32
F64 = torch.float64
f32 = np.float32
NEVER = 2 ** 31 - 1
POOL = 100  # grains per voice (voice.rs:33)
WINDOW_N = 2048
CHUNK = 2048
ENVELOPE_THRESHOLD = 1e-5
_M32 = 0xFFFFFFFF
BIPOLAR_SOURCES = ("LFO1", "LFO2")


def r32(x) -> float:
    """The float32 reciprocal of a constant, as the engine multiplies by
    it."""
    return float(f32(1.0) / f32(x))


def fma32(a, b, c) -> torch.Tensor:
    """``a * b + c`` in float64 (exact for float32 ``a`` and ``b``),
    rounded once to float32."""
    return (torch.as_tensor(a).to(F64) * b + c).to(F32)


def hash_uniform(seed, k) -> torch.Tensor:
    """A splitmix-style 32-bit hash of ``(seed, k)`` (int64 tensors that
    broadcast) as a float32 value in ``[-1, 1)``."""
    def mul(x, c):  # (x * c) mod 2**32, in 16-bit halves of c
        return ((x * (c & 0xFFFF)) + (((x * (c >> 16)) & 0xFFFF) << 16)) & _M32

    x = mul(k & _M32, 0x9E3779B9) ^ (seed & _M32)
    x = mul(x ^ (x >> 16), 0x85EBCA6B)
    x = mul(x ^ (x >> 13), 0xC2B2AE35)
    x = x ^ (x >> 16)
    return (x.to(F32) / float(2 ** 32)) * 2.0 - 1.0


def mono_at_rate(table, in_rate: int, sample_rate: int) -> np.ndarray:
    """The sample as the grains read it: the channels' mean, resampled by
    the 4-point Catmull-Rom interpolation to ``sample_rate`` (zero outside
    the sample), in float64."""
    mono = np.asarray(table, np.float64).mean(axis=0)
    if in_rate == sample_rate:
        return mono
    ratio = in_rate / sample_rate
    n_out = max(int(len(mono) / ratio), 1)
    pos = np.arange(n_out) * ratio
    k = np.floor(pos).astype(np.int64)
    fr = pos - k

    def g(i):
        return np.where((i >= 0) & (i < len(mono)),
                        mono[np.clip(i, 0, len(mono) - 1)], 0.0)
    ym1, y0, y1, y2 = g(k - 1), g(k), g(k + 1), g(k + 2)
    c1 = 0.5 * (y1 - ym1)
    c2 = ym1 - 2.5 * y0 + 2.0 * y1 - 0.5 * y2
    c3 = 0.5 * (y2 - ym1) + 1.5 * (y0 - y1)
    return ((c3 * fr + c2) * fr + c1) * fr + y0


def lfo_sine(age, rate: float, sample_rate: int) -> torch.Tensor:
    """The stock LFO's float32 sine at each sample's note age (its phase
    restarts at the note's start)."""
    inc = f32(f32(rate) * f32(r32(sample_rate)))
    raw = torch.clamp(age.to(F32), min=0.0) * float(inc)
    phase = raw - torch.floor(raw)
    tau = 2.0 * math.pi
    return dsp.sine_approx(torch.where(phase < 0.5, phase * tau,
                                       (phase - 1.0) * tau))


def _segmented_sum(start, steps, last, restart):
    """``start`` plus the running sum of ``steps`` [R, n] in float64, begun
    anew from ``restart`` [R, n] at each note start (``last``: each
    sample's latest start in the chunk, -1 where none; that start's step
    included), rounded once to float32."""
    run = torch.cumsum(steps.to(F64), dim=-1)
    base = start.to(F64)[:, None]
    since = torch.gather(run - steps.to(F64), -1, last.clamp(min=0))
    base = torch.where(last >= 0, restart.to(F64), base)
    run = run - torch.where(last >= 0, since, 0.0)
    return (base + run).to(F32)


class GranularReference(SamplerReference):
    """``lanes`` independent granular samplers of ``voices`` voices over
    ``table`` (float32 [ch, frames] at ``in_rate``), rendered at
    ``sample_rate`` in stereo, one block of ``block_frames`` at a time.

    ``envelope``: the voice AHDSR (attack, hold, decay, sustain, release);
    ``granular``: ``size_ms``, ``density_hz``, ``variation``, ``spray``,
    ``pan_spread``, ``position``, ``step``, ``direction`` and
    ``max_read_speed`` (Cloud mode, the Hann window); ``routings``:
    ``[source, target, amount, bipolar]`` of the stock sources;
    ``lfo_rates``: LFO1's and LFO2's rates (sines); ``loop``: a loop range
    ``(start, end)`` in the sample's frames, or None."""

    def __init__(self, table, in_rate: int, sample_rate: int, lanes: int,
                 block_frames: int, voices: int, envelope, granular: dict,
                 routings, device, dtype=torch.float64, volume: float = 1.0,
                 lfo_rates=(1.0, 2.0), loop=None, seed: int = 0x6A17):
        super().__init__(table, in_rate, sample_rate, lanes, block_frames,
                         voices, envelope, device, dtype, volume=volume)
        if granular.get("window", "Hann") != "Hann" or \
                granular.get("overlap_mode", "Cloud") != "Cloud":
            raise ValueError("the reference renders Cloud mode, Hann window")
        torch.backends.cuda.matmul.allow_tf32 = False
        self.g = dict(granular)
        self.slots = [_Voices(voices) for _ in range(lanes)]
        mono = mono_at_rate(table, in_rate, sample_rate)
        self.file_frames = len(mono)
        self.mono = torch.as_tensor(mono, device=device)
        self.src_frames = int(np.asarray(table).shape[-1])
        self.lfo_rates = lfo_rates
        self.routings = [(s, t, float(f32(a)), bool(b))
                         for s, t, a, b in routings]
        self.loop = loop
        self.seed = seed
        g = self.g
        for pid, key in (("GPOS", "position"), ("GSIZ", "size_ms"),
                         ("GDEN", "density_hz"), ("GVAR", "variation"),
                         ("GSPY", "spray"), ("GPAN", "pan_spread"),
                         ("GSTP", "step")):
            self.params[pid] = Param(float(g[key]), "step", lanes, device,
                                     dtype)
        self.direction = ("Forward", "Backward", "Random").index(
            g.get("direction", "Forward"))
        self.lut = 0.5 * (1.0 - torch.cos(
            2.0 * math.pi * torch.arange(WINDOW_N, dtype=F64, device=device)
            / WINDOW_N))
        rows = lanes * voices
        self.pool = {
            "trig": torch.full((rows, POOL), NEVER, dtype=torch.int64,
                               device=device),
            "dur": torch.zeros((rows, POOL), dtype=torch.int64, device=device),
            "pos0": torch.zeros((rows, POOL), dtype=F32, device=device),
            "inc": torch.zeros((rows, POOL), dtype=F32, device=device),
            "winc": torch.zeros((rows, POOL), dtype=F32, device=device),
            "loop": torch.zeros((rows, POOL), dtype=torch.bool,
                                device=device),
            "vol": torch.zeros((rows, POOL), dtype=dtype, device=device),
            "pan": torch.zeros((rows, POOL), dtype=dtype, device=device)}
        self.phase = torch.ones(rows, dtype=F32, device=device)
        self.playhead = torch.zeros(rows, dtype=F32, device=device)
        self.in_loop = torch.zeros(rows, dtype=torch.bool, device=device)
        self.draws = torch.zeros(rows, dtype=torch.int64, device=device)
        voice_no = torch.arange(1, voices + 1, dtype=torch.int64,
                                device=device).repeat(lanes)
        self.row_seed = seed ^ (voice_no * 0x51ED)

    def _envelope(self, c, rel_at):
        """The AHDSR at run ``c`` of notes released after run ``rel_at``,
        as ``reference/sampler.py`` writes it, with a decay of no length
        going straight to the sustain level."""
        a, h, d, s, r = self.env
        if d > 0.0:
            return super()._envelope(c, rel_at)
        sr = self.sr
        a_runs = math.ceil(f32(1.0) / (f32(1.0) / (f32(a) * f32(sr))))
        h_runs = math.ceil(f32(h) * f32(sr))

        def held(c):
            attack = torch.clamp(c / (a * sr), max=1.0)
            return torch.where(c <= a_runs, attack,
                               torch.where(c <= a_runs + h_runs, 1.0, s))

        level = torch.where(rel_at >= 1.0, held(torch.clamp(rel_at, min=1.0)
                                                .nan_to_num(posinf=1.0)), 0.0)
        rel = level * (1.0 - (c - rel_at) / (r * sr))
        rel = torch.where((rel <= 0.001) | (level <= dsp.F32_EPS), 0.0, rel)
        return torch.where(c < 1.0, 0.0,
                           torch.where(c > rel_at, rel, held(c)))

    def _segments(self, lane: int, bs: int):
        """Per voice, the continuing note (or None) and the notes that
        start in the block."""
        out = []
        for v, placed in enumerate(self.slots[lane].placed):
            before = [nt for nt in placed if nt.start < bs]
            cont = before[-1] if before and before[-1].cut > bs else None
            out.append([cont] + [nt for nt in placed if nt.start >= bs])
            self.slots[lane].placed[v] = placed[-1:]
        return out

    def step(self) -> torch.Tensor:
        """The next block of every lane: [lanes, 2, n]."""
        n, dt, dev, sr = self.n, self.dt, self.dev, self.sr
        bs = self.block_index * n
        pv = {k: p.block(n, sr) for k, p in self.params.items()}
        segs = []
        for lane in range(self.lanes):
            self._allocate(lane, bs + n)
            self.notes[lane] = []
            segs += self._segments(lane, bs)
        k = max(len(s) for s in segs) + 1

        def table(fn, idle, dtype):  # [R, K] per note
            return torch.tensor([[idle if nt is None else fn(nt) for nt in s]
                                 + [idle] * (k - len(s)) for s in segs],
                                dtype=dtype, device=dev)

        i = torch.arange(n, device=dev)
        starts = table(lambda nt: nt.start - bs, n, torch.int64)[:, 1:]
        seg = torch.searchsorted(starts.contiguous(),
                                 i.expand(len(segs), n).contiguous(),
                                 right=True)  # [R, n]: 0 the continuing note

        def at(fn, idle, dtype):
            return table(fn, idle, dtype).gather(1, seg)

        age = i + at(lambda nt: bs - nt.start, 0, torch.int64)
        exists = at(lambda nt: True, False, torch.bool)
        vel = at(lambda nt: float(f32(nt.vel)), 0.0, F32)
        note = at(lambda nt: float(nt.note), 60.0, F32)
        rels = table(lambda nt: float(f32(nt.release - nt.start)), math.inf,
                     F32)
        rel = rels.gather(1, seg)
        held = exists & (age.to(F32) < rel) & (vel > 0.0)
        start = at(lambda nt: nt.start, NEVER, torch.int64)
        speed = at(lambda nt: float(f32(2.0 ** ((nt.note - 60) / 12.0))),
                   1.0, F32)
        pan = at(lambda nt: float(nt.pan), 0.0, dt)

        # the modulation matrix, float32
        src = {"LFO1": lfo_sine(age, self.lfo_rates[0], sr),
               "LFO2": lfo_sine(age, self.lfo_rates[1], sr),
               "VELM": vel, "KEYM": note * r32(127.0)}
        mods = {}
        for s, t, amount, bipolar in self.routings:
            x = src[s]
            if s in BIPOLAR_SOURCES and not bipolar:
                x = (x + 1.0) * 0.5
            elif bipolar and s not in BIPOLAR_SOURCES:
                x = (x - 0.5) * 2.0
            term = x * amount
            mods[t] = term if t not in mods else mods[t] + term

        def rows(x):  # a lane parameter [lanes, n] -> [R, n]
            return x.repeat_interleave(self.voices, 0)

        def modulated(pid, scaled):
            """A granular parameter [R, n] in float32, its modulation
            added (or, ``scaled``, as a factor 1 + modulation)."""
            p = rows(pv[pid]).to(F32)
            if pid not in mods:
                return p
            return p * (1.0 + mods[pid]) if scaled else p + mods[pid]

        zero = torch.zeros_like(vel)
        inputs = {
            "held": held, "start": start, "speed": speed,
            "vol": rows(pv["SVOL"]).to(dt) * vel.to(dt),
            "pan": torch.clamp(rows(pv["SPAN"]).to(dt) + pan, -1.0, 1.0),
            "size_ms": modulated("GSIZ", True),
            "density": modulated("GDEN", True),
            "variation": modulated("GVAR", False),
            "spray": modulated("GSPY", False),
            "pan_spread": modulated("GPAN", False),
            "position": rows(pv["GPOS"]).to(F32),
            "pos_mod": mods.get("GPOS", zero),
            "step": rows(pv["GSTP"]).to(F32),
            "speed_mod": mods.get("GSTP", zero),
        }
        cn = CHUNK if n > CHUNK and n % CHUNK == 0 else n
        audio = torch.cat([self._chunk(bs + t0, cn, {
            key: x[:, t0:t0 + cn] for key, x in inputs.items()})
            for t0 in range(0, n, cn)], dim=-1)  # [R, 2, n]

        env = self._envelope((age + 1).to(dt), rels.to(dt).gather(1, seg))
        voice = audio * (env * exists.to(dt))[:, None, :]
        self.block_index += 1
        return voice.view(self.lanes, self.voices, 2, n).sum(dim=1)

    def _chunk(self, f0: int, cn: int, x: dict) -> torch.Tensor:
        """Trigger, allocate and render every voice's grains over the
        ``cn`` frames from ``f0``: [R, 2, cn]."""
        dt, dev, sr = self.dt, self.dev, self.sr
        pool, nrows = self.pool, self.lanes * self.voices
        ii = torch.arange(cn, device=dev)
        frames = f0 + ii
        ns = x["start"]
        on = frames >= ns  # a note holds the voice
        starts = ns == frames  # a note starts at the sample
        last = torch.cummax(torch.where(starts, ii, -1), dim=-1).values

        # the playhead, with the loop-entry latch
        inv_frames = r32(self.file_frames)
        step_inc = x["step"].to(F32) * (1.0 + x["speed_mod"]) * inv_frames
        pos_at_start = torch.gather(x["position"].to(F32), 1,
                                    last.clamp(min=0))
        ph_raw = _segmented_sum(self.playhead, torch.where(on, step_inc, 0.0),
                                last, pos_at_start)
        wrapped = torch.remainder(ph_raw, 1.0)
        if self.loop is not None:
            inv = f32(1.0 / self.src_frames)
            ls = float(f32(f32(self.loop[0]) * inv))
            le = float(f32(f32(self.loop[1]) * inv))
            ll = float(f32(max(f32(le) - f32(ls), 1e-9)))
            inside = (wrapped >= ls) & (wrapped < le)
            count = torch.cumsum(inside.to(torch.int64), -1)
            count = count - torch.where(last >= 0, torch.gather(
                count - inside.to(torch.int64), 1, last.clamp(min=0)), 0)
            entered = (count > 0) | (self.in_loop[:, None] & (last < 0))
            playhead = torch.where(
                entered, ls + torch.remainder(ph_raw - ls, ll), wrapped)
        else:
            ls, ll = 0.0, 1.0
            entered = torch.zeros_like(on)
            playhead = wrapped
        base_pos = torch.where(x["step"] == 0.0, x["position"].to(F32),
                               playhead) + x["pos_mod"]

        # the density phase accumulator and its triggers
        dens = torch.clamp(x["density"].to(F32), 1.0, 100.0)
        tp = _segmented_sum(self.phase, torch.where(on, dens * r32(sr), 0.0),
                            last, torch.ones_like(dens))
        prev = torch.where(starts, 1.0, torch.cat(
            [self.phase[:, None], tp[:, :-1]], dim=1))
        armed = starts | ((ii == 0) & (self.phase >= 1.0)[:, None])
        fire = ((torch.floor(tp) > torch.floor(prev)) | armed) & x["held"] & on
        most = int(math.ceil(100.0 * cn / sr)) + 2
        times = torch.sort(torch.where(fire, ii, cn), dim=1).values[:, :most]
        last_note = ii >= last[:, -1:]
        self.phase = torch.where(
            (x["held"] & last_note).any(dim=-1), tp[:, -1] - torch.floor(
                tp[:, -1]), torch.where(last[:, -1] >= 0, 1.0, self.phase))
        self.playhead = playhead[:, -1]
        self.in_loop = entered[:, -1]

        # each trigger takes the first free slot with its 7 draws
        ms_to_frames = float(f32(f32(sr) * f32(r32(1000.0))))
        inv_file_secs = r32(f32(self.file_frames / sr))
        cap = float(f32(self.g.get("max_read_speed", 4.0)))
        rows = torch.arange(nrows, device=dev)
        for j in range(times.shape[1]):
            t = times[:, j]
            valid = t < cn
            ts = t.clamp(max=cn - 1)[:, None]

            def at_t(y):  # each row's value at its trigger
                return torch.gather(y, 1, ts)[:, 0]

            def pick(key):
                return at_t(x[key])
            u = hash_uniform(self.row_seed[:, None],
                             self.draws[:, None] * 8
                             + torch.arange(7, device=dev))  # [R, 7]
            half = (u + 1.0) * 0.5
            var = torch.clamp(pick("variation").to(F32), 0.0, 1.0)
            vol_scale = fma32(-var, half[:, 0], 1.0)
            semis = var * (half[:, 1] - 0.5) + var * u[:, 4] * 0.5
            scale = (1.0 - 0.75 * var) + (2.75 * var) * half[:, 2]
            size = torch.clamp(pick("size_ms").to(F32), 1.0, 1000.0)
            dur = torch.clamp((size * scale * ms_to_frames).to(torch.int64),
                              min=2)
            spread = torch.clamp(pick("pan_spread"), 0.0, 1.0).to(dt)
            gpan = torch.clamp(spread * u[:, 3].to(dt) + pick("pan"),
                               -1.0, 1.0)
            reverse = (torch.full_like(valid, self.direction == 1)
                       | ((self.direction == 2) & (u[:, 5] > 0.0)))
            spray = torch.clamp(pick("spray").to(F32), 0.0, 1.0)
            gpos = fma32(spray * u[:, 6], inv_file_secs, at_t(base_pos))
            into = at_t(entered)
            gpos = torch.where(into, ls + torch.remainder(gpos - ls, ll),
                               gpos)
            gpos = torch.remainder(gpos, 1.0)
            pitch = torch.exp2((semis * r32(12.0)).to(F64)).to(F32)
            gspeed = torch.clamp(pick("speed") * pitch, max=cap)
            ginc = gspeed * inv_frames * torch.where(reverse, -1.0, 1.0)
            gvol = torch.clamp(pick("vol") * vol_scale.to(dt), 0.0, 100.0)

            free = (pool["trig"] == NEVER) | (pool["trig"] + pool["dur"] <= f0)
            take = valid & free.any(dim=1)
            slot = torch.argmax(free.to(torch.int8), dim=1)
            r, s = rows[take], slot[take]
            for key, val in (("trig", f0 + t), ("dur", dur), ("pos0", gpos),
                             ("inc", ginc), ("winc", 1.0 / dur.to(F32)),
                             ("loop", into), ("vol", gvol), ("pan", gpan)):
                pool[key][r, s] = val[take].to(pool[key].dtype)
            self.draws = self.draws + valid.to(torch.int64)

        # every slot's grain over the chunk
        local = frames - pool["trig"][..., None]  # [R, P, cn]
        live = (local >= 0) & (local < pool["dur"][..., None])
        live &= ~((pool["trig"][..., None] < ns[:, None, :])
                  & (frames >= ns[:, None, :]))
        localf = local.to(F32)
        phase = torch.clamp(localf.to(dt) * pool["winc"][..., None].to(dt),
                            0.0, 1.0)
        idx_f = phase * (WINDOW_N - 1)
        idx = torch.clamp(torch.floor(idx_f).to(torch.int64), max=WINDOW_N - 2)
        frac = idx_f - idx
        lut = self.lut.to(dt)
        window = lut[idx] * (1.0 - frac) + lut[idx + 1] * frac
        weight = window * pool["vol"][..., None]
        weight = torch.where(live & (weight > ENVELOPE_THRESHOLD), weight, 0.0)
        pos = fma32(localf, pool["inc"][..., None], pool["pos0"][..., None])
        pos = torch.where(pool["loop"][..., None],
                          ls + torch.remainder(pos - ls, ll),
                          torch.remainder(pos, 1.0))
        fidx = pos * float(f32(self.file_frames - 1))
        k0 = torch.floor(fidx)
        fr = (fidx - k0).to(dt)
        k0 = k0.to(torch.int64)
        src = self.mono.to(dt)

        def tap(o):
            return src[torch.remainder(k0 + o, self.file_frames)]
        ym1, y0, y1, y2 = tap(-1), tap(0), tap(1), tap(2)
        c1 = 0.5 * (y1 - ym1)
        c2 = ym1 - 2.5 * y0 + 2.0 * y1 - 0.5 * y2
        c3 = 0.5 * (y2 - ym1) + 1.5 * (y0 - y1)
        grains = (((c3 * fr + c2) * fr + c1) * fr + y0) * weight
        pan = pool["pan"][..., None]
        return torch.stack([((1.0 - pan) * 0.5 * grains).sum(dim=1),
                            ((1.0 + pan) * 0.5 * grains).sum(dim=1)], dim=1)
