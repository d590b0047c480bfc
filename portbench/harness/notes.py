"""The ``lanes_notes`` entry: the ``lanes`` entry with a note part per lane.

A mix for it adds to the ``lanes`` mix ``note_ons_per_audio_s`` (a fixed
count per block, as ``traffic.py`` counts its events), ``notes`` and
``velocity`` (uniform, the notes whole), and ``note_seconds`` (how long
each note is held, log-uniform).  Every value is drawn from (seed, lane,
block): a note's onset is uniform inside its block and its note-off lands
at onset + duration, often in a later block.

The entry schedules each note on its lane's program through the node's
public ``note_on`` / ``note_off`` (the node the configuration names
``NOTE_TARGET``), keeping the note id each gives, and logs each note as
``("note", key, note, onset, velocity, off)`` with the lane's other events,
for the reference.  A configuration that renders notes adds the entry to
``ENTRIES`` when it is loaded.
"""

from __future__ import annotations

import math

import numpy as np

from harness.entries import LanesEntry
from harness.traffic import _count


def note_events(mix: dict, seed: int, lane: int, block: int, sample_rate: int,
                key: str) -> list:
    """The notes of ``lane`` in ``block``, in onset order: ``("note", key,
    note, onset, velocity, off)`` with frames absolute."""
    n = mix["block_frames"]
    k = _count(mix["note_ons_per_audio_s"], block, n / sample_rate)
    rng = np.random.default_rng([seed & (2 ** 64 - 1), lane, block, 0x40E5])
    onsets = np.sort(rng.integers(0, n, size=k))
    notes = rng.integers(mix["notes"][0], mix["notes"][1] + 1, size=k)
    vels = rng.uniform(*mix["velocity"], size=k)
    lo, hi = (math.log(s) for s in mix["note_seconds"])
    held = np.rint(np.exp(rng.uniform(lo, hi, size=k)) * sample_rate)
    f0 = block * n
    return [("note", key, int(m), f0 + int(t), float(v), f0 + int(t) + int(d))
            for t, m, v, d in zip(onsets, notes, vels, held)]


class NotesEntry(LanesEntry):
    """``LanesEntry`` whose lanes also get the mix's notes."""

    def __init__(self, *a):
        super().__init__(*a)
        self.key = self.cfg.NOTE_TARGET
        self.note_ids = [[] for _ in range(self.lanes)]  # per lane, in order

    def _events(self, b):
        evs = super()._events(b)
        logged = self.log[-1] = list(evs)  # the events applied, and notes
        for lane, (prog, nodes) in enumerate(self.lane_progs):
            node = nodes[self.key]
            notes = note_events(self.mix, self.traffic.seed, lane, b,
                                self.spec["sample_rate"], self.key)
            for _, _, note, onset, vel, off in notes:
                nid = node.note_on(note, vel, time=onset)
                node.note_off(nid, time=off)
                self.note_ids[lane].append(nid)
            logged[lane] = logged[lane] + notes
        return evs


def note_log(mix: dict, traffic, lanes: int, blocks: int, sample_rate: int,
             key: str) -> list:
    """The events ``NotesEntry`` logs for ``blocks`` blocks (the traffic's,
    then the notes), without a program: for a reference render alone, such
    as the correctness check's control."""
    return [[traffic.events(lane, b) + note_events(
        mix, traffic.seed, lane, b, sample_rate, key)
        for lane in range(lanes)] for b in range(blocks)]
