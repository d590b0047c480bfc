"""The generators' voice plan: note events placed on voices block by block,
at a host cost per block that does not grow with the session.

Behavioural spec: reference src/generator/sampler.rs:826-860 (a note-on
takes the lowest free voice, else steals the longest-releasing voice, with
an envelope, else the oldest by playback id) and src/generator.rs:172-226
(note on / off, all notes off, per-note volume, panning and speed).

The JAX package replays every event since the program started whenever
one is added.  The plan instead takes each event once, when the block after
it is lowered, and keeps only what a later block can still need:

* note-ons and per-note automation wait in a queue ordered by
  ``(frame, note id, arrival)``, the order of the replay's stable sort, and
  are applied when a lowered block reaches their frame;
* a note-off (or all notes off) sets its note's release as soon as it is
  taken, the earliest valid one winning as in the replay.  A release later
  than a decision's frame changes neither which voices are free nor which
  are releasing at that frame, so placements equal the replay's; only
  whether a release at the very frame of a note-on counts as releasing
  depends on the two events' order, which each release's key keeps;
* once a block is lowered, a voice keeps only its last note that started
  before the block and the notes after it: the others have been cut or
  have ended, and events for them are dropped.

Every event at or after the first frame not yet lowered is therefore placed
exactly as the replay places it.  An event that sorts before an event the
plan already applied (scheduled in a block already lowered, behind a later
note) takes effect at that applied event's frame: what the plan placed
stands, where the replay would move the later notes.  It also misses an
all-notes-off between its own frame and that one.  A block may be lowered
again until a later block has been lowered; the generator makes a new plan
from its scheduled events to lower an earlier one.
"""

from __future__ import annotations

import bisect
import copy
import dataclasses
import heapq
import math
from typing import Optional

from .. import tracing
from ..events import ParamTimeline

_NOT_RELEASED = (math.inf, 0, 0)


def note_speed(note: int) -> float:
    """A note's speed multiplier before automation, 2^((note - 60) / 12)."""
    return 2.0 ** ((note - 60) / 12.0)


@dataclasses.dataclass
class NoteSegment:
    """One note on one voice: from ``start`` until the next note of the
    voice (or ``cut``, where that note stole the voice)."""

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
    key: tuple = (0, 0, 0)  # the note-on's (frame, note id, arrival)
    release_key: tuple = _NOT_RELEASED  # the releasing event's
    free_at: Optional[float] = None  # the voice's free frame, once asked

    def speed0(self) -> float:
        """Note-derived speed multiplier before automation."""
        return note_speed(self.note)


class VoicePlan:
    """The placed notes of one generator (``gen``: its ``options.voices``,
    ``envelope`` and ``_voice_end``) at ``sample_rate``.

    ``voices[v]`` lists voice v's kept notes in start order.  Counters per
    call, while tracing is on: ``generator.plan_events`` (events taken),
    ``generator.steals``."""

    def __init__(self, gen, sample_rate: int):
        self.gen = gen
        self.sr = sample_rate
        self.voices: list[list[NoteSegment]] = [
            [] for _ in range(gen.options.voices)]
        self.notes: dict[int, NoteSegment] = {}  # note id -> kept note
        self.queue: list = []  # (frame, note id, arrival, event), a heap
        self.waiting: dict[int, tuple] = {}  # queued note-on id -> its key
        self.offs: dict[int, tuple] = {}  # queued note-on id -> its off's key
        self.all_offs: list[tuple] = []  # keys that a queued note may meet
        self.arrivals = 0
        self.last = (-math.inf, 0, 0)  # the key of the last applied event
        self.pruned_to = 0  # the start of the last block pruned for
        self.max_speed = 1.0  # the largest note speed ever scheduled
        self.has_auto = False  # any per-note automation ever scheduled
        self.steals = 0  # steals since the plan began

    # ------------------------------------------------------------------
    # taking events
    # ------------------------------------------------------------------

    def take(self, events) -> int:
        """Take new events (in the order they were scheduled); returns
        their number."""
        for ev in events:
            self.arrivals += 1
            key = (ev.time, ev.note_id, self.arrivals)
            if ev.kind == "on":
                heapq.heappush(self.queue, key + (ev,))
                self.waiting[ev.note_id] = key
                self.max_speed = max(self.max_speed, note_speed(ev.note))
            elif ev.kind == "off":
                seg = self.notes.get(ev.note_id)
                if seg is not None:
                    if key > seg.key:
                        _release(seg, key)
                elif key > self.waiting.get(ev.note_id, key):
                    self.offs[ev.note_id] = min(
                        key, self.offs.get(ev.note_id, _NOT_RELEASED))
            elif ev.kind == "all_off":
                for segs in self.voices:
                    for seg in segs:
                        if seg.key < key:
                            _release(seg, key)
                bisect.insort(self.all_offs, key)
            else:  # set_vol / set_pan / set_spd
                self.has_auto = True
                if ev.kind == "set_spd":
                    self.max_speed = max(self.max_speed, ev.value)
                heapq.heappush(self.queue, key + (ev,))
        tracing.count("generator.plan_events", len(events))
        return len(events)

    # ------------------------------------------------------------------
    # applying them
    # ------------------------------------------------------------------

    def advance(self, until: float):
        """Apply every queued event before frame ``until``."""
        q = self.queue
        while q and q[0][0] < until:
            t, nid, arrival, ev = heapq.heappop(q)
            key = (t, nid, arrival)
            if key < self.last:  # late: at the last applied event's frame
                t = self.last[0]
            applied = (t, nid, arrival)
            if ev.kind == "on":
                self._place(ev, t, key, applied)
            else:
                self._automate(ev, t)
            self.last = max(self.last, applied)

    def _place(self, ev, t: int, key: tuple, applied: tuple):
        gen, voices = self.gen, self.voices
        del self.waiting[ev.note_id]
        idx = next((v for v, segs in enumerate(voices)
                    if not segs or self._free_at(segs[-1]) <= t), None)
        if idx is None:
            # steal priority (reference sampler.rs:826-860): a) with an
            # envelope, the longest-releasing voice (earliest release start;
            # without an envelope the reference never checks the release
            # stage), then b) the oldest active voice by playback id
            releasing = [
                (segs[-1].release, v) for v, segs in enumerate(voices)
                if segs[-1].release_key < applied
            ] if gen.envelope is not None else []
            if releasing:
                idx = min(releasing)[1]
            else:
                idx = min(range(len(voices)),
                          key=lambda v: voices[v][-1].note_id)
        segs = voices[idx]
        if segs and self._free_at(segs[-1]) > t:
            segs[-1].cut = min(segs[-1].cut, t)
            segs[-1].free_at = None
            self.steals += 1
            tracing.count("generator.steals")
        seg = NoteSegment(t, ev.note, ev.note_id, ev.volume, ev.panning,
                          key=key)
        off = self.offs.pop(ev.note_id, None)
        if off is not None:
            _release(seg, off)
        i = bisect.bisect_right(self.all_offs, key)
        if i < len(self.all_offs):
            _release(seg, self.all_offs[i])
        segs.append(seg)
        self.notes[ev.note_id] = seg

    def _free_at(self, seg: NoteSegment) -> float:
        """The frame from which ``seg``'s voice is free (``_voice_end``),
        kept until the note's release or cut changes."""
        if seg.free_at is None:
            seg.free_at = self.gen._voice_end(seg, self.sr)
        return seg.free_at

    def _automate(self, ev, t: int):
        seg = self.notes.get(ev.note_id)
        if seg is None or t < seg.start:
            return
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
                seg.spd_tl.set_glide_at(t, ev.value, ev.glide, self.sr)
            else:
                seg.spd_tl.set_at(t, ev.value)

    # ------------------------------------------------------------------
    # a block
    # ------------------------------------------------------------------

    def block(self, block_start: int, block_len: int):
        """Apply the events before the block's end and forget the notes that
        can sound in no block from ``block_start`` on.  Returns each voice's
        (continuing note or None, the notes starting in the block)."""
        if block_start < self.pruned_to:
            raise ValueError(f"block at frame {block_start} lowered after "
                             f"the plan moved to frame {self.pruned_to}")
        self.advance(block_start + block_len)
        self.pruned_to = block_start
        out = []
        for segs in self.voices:
            j = 0
            while j + 1 < len(segs) and segs[j + 1].start < block_start:
                j += 1
            if j:
                for seg in segs[:j]:
                    self.notes.pop(seg.note_id, None)
                del segs[:j]
            cont = None
            if segs and segs[0].start < block_start:
                cont = segs[0] if segs[0].cut > block_start else None
                trigs = segs[1:]
            else:
                trigs = segs
            out.append((cont, trigs))
        # all-notes-offs that no queued note-on can meet any more
        del self.all_offs[:bisect.bisect_right(self.all_offs, self.last)]
        return out

    def finished(self) -> "VoicePlan":
        """A copy of the plan with every queued event applied (this plan
        is left as it is)."""
        gen, self.gen = self.gen, None
        try:
            done = copy.deepcopy(self)
        finally:
            self.gen = gen
        done.gen = gen
        done.advance(math.inf)
        return done


def _release(seg: NoteSegment, key: tuple):
    """Release ``seg`` at the event ``key`` unless an earlier one did."""
    if key < seg.release_key:
        seg.release_key = key
        seg.release = float(max(key[0], seg.start))
        seg.free_at = None
