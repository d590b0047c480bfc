"""The plain reference of a one-sample instrument: upstream's
src/generator/sampler.rs, a polyphonic sampler of one buffer with an AHDSR
envelope (or one-shot playback), voice stealing and note events.

Written from the sampler's documented behaviour, in plain PyTorch; it
imports nothing of the program under test.  Per lane, an allocator of its
own takes the note events in time order (ties by note id, then by the order
they were given) and places each note on a voice: the lowest free voice,
else, with an envelope, the voice whose note was released earliest, else
the voice with the oldest note.  A voice's note stops where its next note
starts, whether that note stole the voice or found it free.  Every note is rendered over its own ``[start, cut)``: its read
positions, the AHDSR written from its definition, its velocity and pan, and
the notes of a block are rendered together, one row per note.

Departures from upstream, each a choice the engine documents:

* a voice with an envelope is free ``0.999 * release * rate + 1`` frames
  after its note-off; upstream frees it once the envelope falls below
  -60 dB, which depends on the level the release starts from (up to about
  15 frames earlier at a 0.6 sustain and a 0.4 s release);
* a one-shot voice (no envelope) is free at the end of its sample (at its
  note's speed and the sampler's transpose and finetune at build) or
  ``fade_out_secs * rate + 1`` frames after its note-off, when its fade
  is still at -40 dB: a note on the voice from then on ends the fade;
* the envelope is the closed form of upstream's stage machine with linear
  curves (no curve scaling), and its parameters stay as built; the attack
  and the hold last as many runs as the engine counts from float32 seconds
  times the rate (a count: 97 runs for a 2 ms hold at 48 kHz, not 96);
* read positions follow the engine's float32 definition (as ``dsp.py``
  says of file sources): each output frame's step is the float32 product
  ``pitch * speed * (buffer rate / output rate)``; a note's positions are
  the running sum of its steps since its start, summed in float64 and
  rounded once to float32 within the block the note starts in, and the
  float32 end position plus the same sum in each later block;
* the read is the 4-point Hermite read of the buffer, zero outside it.

Every audio value is computed in ``dtype``.  The sampler's ``SVOL`` and
``SPAN`` follow the engine's exponential smoother and ``STRN`` / ``SFTN``
step (``params.py``).
"""

from __future__ import annotations

import heapq
import math

import numpy as np
import torch

from . import dsp
from .params import Param

F32 = torch.float32
SILENCE = 0.001  # the release snaps to 0 below -60 dB


class _Note:
    __slots__ = ("id", "start", "note", "vel", "pan", "release", "cut",
                 "end_pos")

    def __init__(self, nid, start, note, vel, pan):
        self.id, self.start, self.note = nid, start, note
        self.vel, self.pan = vel, pan
        self.release = math.inf
        self.cut = math.inf
        self.end_pos = None  # float32 position after its last block


class SamplerReference:
    """``lanes`` independent samplers of ``table`` (float32 [ch, frames] at
    ``in_rate``) rendered at ``sample_rate`` into ``channels`` channels, one
    block of ``block_frames`` at a time.  ``envelope`` is (attack, hold,
    decay, sustain, release) in seconds and level, or None for one-shot
    playback."""

    def __init__(self, table, in_rate: int, sample_rate: int, lanes: int,
                 block_frames: int, voices: int, envelope, device,
                 dtype=torch.float64, volume: float = 1.0,
                 panning: float = 0.0, transpose: int = 0,
                 finetune: int = 0, fade_out_secs: float = 0.05,
                 channels: int = 2):
        self.table = torch.as_tensor(np.asarray(table, np.float32),
                                     device=device)
        self.frames = self.table.shape[-1]
        self.in_rate, self.sr = in_rate, sample_rate
        self.ratio = float(np.float32(in_rate / sample_rate))
        self.lanes, self.n, self.voices = lanes, block_frames, voices
        self.env = envelope
        self.fade = fade_out_secs
        self.transpose, self.finetune = transpose, finetune
        self.channels = channels
        self.dev, self.dt = device, dtype
        self.params = {
            "SVOL": Param(volume, "exp", lanes, device, dtype, sample_rate),
            "SPAN": Param(panning, "exp", lanes, device, dtype, sample_rate),
            "STRN": Param(float(transpose), "step", lanes, device, dtype),
            "SFTN": Param(float(finetune), "step", lanes, device, dtype)}
        self.queue = [[] for _ in range(lanes)]  # (frame, id, order, ...)
        self.slots = [[None] * voices for _ in range(lanes)]
        self.notes = [[] for _ in range(lanes)]  # placed, maybe sounding
        self.order = 0
        self.block_index = 0

    # ------------------------------------------------------------------
    # events
    # ------------------------------------------------------------------

    def note(self, lane: int, nid: int, start: int, note: int,
             velocity: float, off: float = math.inf, panning: float = 0.0):
        """Note ``nid`` (ids order the notes of equal start) from frame
        ``start`` to its note-off at ``off``."""
        self._push(lane, start, nid, ("on", nid, note, velocity, panning))
        if off < math.inf:
            self._push(lane, off, nid, ("off", nid))

    def set(self, lane: int, pid: str, frame: int, value: float):
        off = frame - self.block_index * self.n
        if not 0 <= off < self.n:
            raise ValueError(f"event at frame {frame} outside block "
                             f"{self.block_index}")
        self.params[pid].events[lane].append((off, value, False))

    def add_event(self, lane: int, ev):
        """A benchmark event: ``("note", key, note, frame, velocity,
        off_frame)`` (its id is the order of the notes given) or ``("set",
        key, pid, frame, value, 0)``."""
        kind, _, pid, frame, value, extra = ev
        if kind == "note":
            self.order += 1
            self.note(lane, self.order, frame, pid, value, extra)
        elif kind == "set":
            self.set(lane, pid, frame, value)
        else:
            raise ValueError(f"the sampler takes no {kind}")

    def _push(self, lane, frame, nid, what):
        self.order += 1
        heapq.heappush(self.queue[lane], (frame, nid, self.order) + what)

    # ------------------------------------------------------------------
    # voices
    # ------------------------------------------------------------------

    def _free_at(self, nt: _Note) -> float:
        """The frame from which the voice of ``nt`` is free."""
        if self.env is not None:
            end = nt.release + self.env[4] * self.sr * 0.999 + 1
        else:
            speed = 2.0 ** ((nt.note - 60) / 12.0 + self.transpose / 12.0
                            + self.finetune / 1200.0)
            end = nt.start + self.frames / max(
                speed * self.in_rate / self.sr, 1e-9)
            end = min(end, nt.release + self.fade * self.sr + 1)
        return min(end, nt.cut)

    def _allocate(self, lane: int, until: int):
        q, slots = self.queue[lane], self.slots[lane]
        notes = {nt.id: nt for nt in self.notes[lane] + slots
                 if nt is not None}
        while q and q[0][0] < until:
            t, _, _, kind, nid, *rest = heapq.heappop(q)
            if kind == "off":
                nt = notes.get(nid)
                if nt is not None and nt.release == math.inf:
                    nt.release = float(max(t, nt.start))
                continue
            free = [v for v, nt in enumerate(slots)
                    if nt is None or self._free_at(nt) <= t]
            if free:
                v = free[0]
            else:
                releasing = sorted((nt.release, v) for v, nt in
                                   enumerate(slots) if nt.release <= t)
                if self.env is not None and releasing:
                    v = releasing[0][1]
                else:
                    v = min(range(len(slots)), key=lambda u: slots[u].id)
            if slots[v] is not None:  # a voice plays one note at a time
                slots[v].cut = min(slots[v].cut, t)
            nt = _Note(nid, t, *rest)
            slots[v] = nt
            notes[nid] = nt
            self.notes[lane].append(nt)

    def _silent_from(self, nt: _Note) -> float:
        """A frame from which the note is silent for good."""
        if self.env is not None:
            return nt.release + self.env[4] * self.sr + 2
        return nt.release + 3 * self.fade * self.sr + 2

    # ------------------------------------------------------------------
    # the render
    # ------------------------------------------------------------------

    def _envelope(self, c, rel_at):
        """The AHDSR at run ``c`` (the note's sample age + 1) of a note
        released after run ``rel_at``, in ``dtype``."""
        a, h, d, s, r = self.env
        sr = self.sr
        a_n, d_n = a * sr, d * sr
        # the runs of the attack and the hold: a count, so taken as the
        # engine counts them, from float32 seconds times the rate
        f32 = np.float32
        a_runs = math.ceil(f32(1.0) / (f32(1.0) / (f32(a) * f32(sr))))
        h_runs = math.ceil(f32(h) * f32(sr))

        def held(c):
            attack = torch.clamp(c / a_n, max=1.0)
            decay = torch.clamp(1.0 - (1.0 - s) * (c - a_runs - h_runs) / d_n,
                                min=s)
            return torch.where(c <= a_runs, attack,
                               torch.where(c <= a_runs + h_runs, 1.0, decay))

        level = torch.where(rel_at >= 1.0, held(torch.clamp(rel_at, min=1.0)
                                                .nan_to_num(posinf=1.0)), 0.0)
        rel = level * (1.0 - (c - rel_at) / (r * sr))
        rel = torch.where((rel <= SILENCE) | (level <= dsp.F32_EPS), 0.0, rel)
        return torch.where(c < 1.0, 0.0,
                           torch.where(c > rel_at, rel, held(c)))

    def step(self) -> torch.Tensor:
        """The next block of every lane: [lanes, channels, n]."""
        n, dt, dev = self.n, self.dt, self.dev
        bs = self.block_index * n
        pv = {k: p.block(n, self.sr) for k, p in self.params.items()}
        pitch = torch.exp2(pv["STRN"] / 12.0 + pv["SFTN"] / 1200.0)  # f32
        out = torch.zeros((self.lanes, self.channels, n), dtype=dt,
                          device=dev)
        idx = torch.arange(n, device=dev)
        for lane in range(self.lanes):
            self._allocate(lane, bs + n)
            live = [nt for nt in self.notes[lane]
                    if nt.cut > bs and self._silent_from(nt) > bs
                    and not (nt.end_pos is not None
                             and nt.end_pos >= self.frames)]
            self.notes[lane] = live
            if live:
                out[lane] = self._render(live, pitch[lane], pv["SVOL"][lane],
                                         pv["SPAN"][lane], bs, idx)
        self.block_index += 1
        return out

    def _render(self, notes, pitch, volume, panning, bs, idx):
        n, dt, dev = self.n, self.dt, self.dev

        def col(vals, dtype=torch.float64):
            return torch.tensor(vals, dtype=dtype, device=dev)[:, None]

        first = col([max(nt.start - bs, 0) for nt in notes], torch.int64)
        stop = col([min(nt.cut - bs, n) for nt in notes], torch.int64)
        speed = col([np.float32(2.0 ** ((nt.note - 60) / 12.0))
                     for nt in notes], F32)
        new = col([nt.end_pos is None for nt in notes], torch.bool)
        carried = col([0.0 if nt.end_pos is None else nt.end_pos
                       for nt in notes], F32)
        on = (idx >= first) & (idx < stop)  # [R, n]

        # positions: float32 steps, summed in float64, rounded once
        steps = torch.where(on, pitch * speed * np.float32(self.ratio), 0.0)
        run = torch.cumsum(steps.double(), dim=-1)
        before = (run - steps.double()).to(F32)
        pos = torch.where(new, before, carried + before)
        end = torch.where(new[:, 0], run[:, -1].to(F32),
                          pos[:, -1] + steps[:, -1])
        for nt, e in zip(notes, end.tolist()):
            nt.end_pos = e
        sounding = on & (pos < self.frames)

        # the 4-point Hermite read of the buffer, zero outside it
        k = torch.floor(pos)
        frac = (pos - k).to(dt)
        ki = k.to(torch.int64)
        src = self.table.to(dt)

        def tap(o):
            i = ki + o
            ok = (i >= 0) & (i < self.frames)
            return torch.where(ok, src[:, i.clamp(0, self.frames - 1)], 0.0)

        ym1, y0, y1, y2 = tap(-1), tap(0), tap(1), tap(2)  # [ch, R, n]
        c1 = 0.5 * (y1 - ym1)
        c2 = ym1 - 2.5 * y0 + 2.0 * y1 - 0.5 * y2
        c3 = 0.5 * (y2 - ym1) + 1.5 * (y0 - y1)
        audio = ((c3 * frac + c2) * frac + c1) * frac + y0

        age = (bs - col([nt.start for nt in notes], torch.int64) + idx).to(dt)
        rel_at = col([nt.release - nt.start for nt in notes], dt)
        if self.env is not None:
            env = self._envelope(age + 1.0, rel_at)
        else:
            # one-shot: a fade that falls by 40 dB over fade_out_secs
            # after note-off, 0 below -80 dB
            k_out = torch.clamp(age - rel_at + 1.0, min=0.0)
            down = torch.exp(-math.log(100.0) * k_out / (self.sr * self.fade))
            env = torch.where(age < rel_at, 1.0,
                              torch.where(down < 1e-4, 0.0, down))
        gain = env * col([nt.vel for nt in notes], dt) * volume.to(dt)
        gain = gain * sounding.to(dt)
        if audio.shape[0] >= 2 and self.channels >= 2:
            chans = [audio[0] * gain, audio[1] * gain]
        else:
            mono = audio.mean(dim=0)
            chans = [mono * gain] * self.channels
        if self.channels >= 2:
            left, right = dsp.pan_gains(panning.to(dt) + col(
                [nt.pan for nt in notes], dt))
            chans[0], chans[1] = chans[0] * left, chans[1] * right
        return torch.stack([c.sum(dim=0) for c in chans])
