"""Generator protocol: note-event-driven polyphonic sources (a copy of
``phonic_tpu/generators/base.py``, pure Python).

Behavioural spec: reference src/generator.rs — `Generator: Source` with note
on/off events (:172-226), playback options (:41-78), transient (play_) vs
fixed (add_) lifecycle.

Host-side note events are scheduled in absolute output frames and lowered
per block into fixed-shape voice tensors by the generator's allocator.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

from ..graph.nodes import Source

_note_ids = itertools.count(1)


@dataclasses.dataclass
class GeneratorPlaybackOptions:
    """reference: src/generator.rs:41-78."""

    volume: float = 1.0
    panning: float = 0.0
    voices: int = 8
    fade_out_secs: float = 0.05
    # enable the per-generator CPU-load probe readable via
    # GeneratorPlaybackHandle.cpu_load() (reference: src/generator.rs:41-78
    # measure_cpu_load option)
    measure_cpu_load: bool = False
    # seconds between Position status events (None = positions never
    # emitted); reference default 1 s (src/generator.rs:60-64)
    playback_pos_emit_rate: Optional[float] = 1.0

    def validate(self):
        """reference: GeneratorPlaybackOptions::validate,
        src/generator.rs:118-140."""
        from ..errors import ParameterError
        if not (self.volume >= 0.0):  # also catches NaN
            raise ParameterError(f"playback options 'volume' value is {self.volume!r}")
        if not (-1.0 <= self.panning <= 1.0):
            raise ParameterError(f"playback options 'panning' value is {self.panning!r}")
        if self.voices < 1:
            raise ParameterError(f"playback options voice count is {self.voices!r}")
        return self


@dataclasses.dataclass
class NoteEvent:
    time: int  # absolute output frame
    kind: str  # "on" | "off" | "all_off" | "set_vol" | "set_pan" | "set_spd"
    note: int = 60
    note_id: int = 0
    volume: float = 1.0
    panning: float = 0.0
    value: float = 0.0  # set_* target value
    glide: Optional[float] = None  # semitones/sec for set_spd


class Generator(Source):
    """Note-event front-end.  Subclasses implement the voice rendering and an
    allocator lowering in ``lower_block_inputs``."""

    def __init__(self, options: Optional[GeneratorPlaybackOptions] = None, name=None):
        super().__init__(name)
        self.options = (options or GeneratorPlaybackOptions()).validate()
        self.events: list[NoteEvent] = []

    def note_on(self, note: int, volume: float = 1.0, panning: float = 0.0,
                time: int = 0) -> int:
        """Schedule a note-on; returns a note id usable with note_off
        (reference: GeneratorPlaybackHandle::note_on,
        src/player/handles/generator.rs:200-240)."""
        nid = next(_note_ids)
        self.events.append(NoteEvent(int(time), "on", int(note), nid,
                                     float(volume), float(panning)))
        return nid

    def note_off(self, note_id: int, time: int = 0):
        self.events.append(NoteEvent(int(time), "off", note_id=note_id))

    def all_notes_off(self, time: int = 0):
        self.events.append(NoteEvent(int(time), "all_off"))

    def set_note_volume(self, note_id: int, volume: float, time: int = 0):
        """Per-note volume (composes with base volume; reference:
        GeneratorPlaybackEvent::SetVolume, sampler voice.rs:270-279)."""
        self.events.append(NoteEvent(int(time), "set_vol", note_id=note_id,
                                     value=float(volume)))

    def set_note_panning(self, note_id: int, panning: float, time: int = 0):
        """Per-note panning (adds to base, clamped; voice.rs:291-300)."""
        self.events.append(NoteEvent(int(time), "set_pan", note_id=note_id,
                                     value=float(panning)))

    def set_note_speed(self, note_id: int, speed: float,
                       glide: Optional[float] = None, time: int = 0):
        """Per-note playback speed, replacing the note-derived pitch ratio;
        with ``glide`` the speed ramps at that many semitones/second
        (reference: GeneratorPlaybackEvent::SetSpeed, voice.rs:238-254)."""
        self.events.append(NoteEvent(int(time), "set_spd", note_id=note_id,
                                     value=float(speed), glide=glide))
