"""Preloaded file playback source (port of ``phonic_tpu/sources/file.py``).

Behavioural spec: reference src/source/file.rs (FilePlaybackOptions :34-93),
src/source/file/preloaded.rs (loop/repeat/seek/stop semantics) and the
wrapper chain the player builds per played file —
Converted -> Amplified -> Panned (src/player.rs:540-559) — fused into one
node: resample+remap, smoothed volume, smoothed constant-power pan,
fade-in/out.

Playback is positional: per-sample read positions are computed
analytically and folded through the loop/repeat map.  A FileSource holds
the configuration; every file source renders as a lane of a
``graph/batching.FileBatch``, which runs the DSP.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from ..errors import ParameterError
from ..graph.nodes import Source
from ..io.decoder import AudioFileBuffer
from ..ops import resample as rs
from ..params import DecibelScaling, FloatParameter, format_gain, format_pan

# int32-safe sentinel: single renders are limited to 2^31-1 frames
NEVER = np.iinfo(np.int32).max


def _host_fade_log1m(duration_secs: float, sample_rate: int) -> float:
    """log(1 - inertia) of the de-click fader, as a Python float."""
    samples = sample_rate * duration_secs / math.log(100.0)
    return math.log1p(-(1.0 - math.exp(-1.0 / max(samples, 1e-9))))


VOLUME = FloatParameter(
    "VOLU", "Volume", 0.0, 4.0, 1.0, scaling=DecibelScaling(-60.0, 12.0),
    formatter=format_gain,
)
PANNING = FloatParameter("PANN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)
SPEED = FloatParameter("SPED", "Speed", 0.001, 16.0, 1.0, smoothing=None)


@dataclasses.dataclass
class FilePlaybackOptions:
    """reference: src/source/file.rs:34-93."""

    volume: float = 1.0
    panning: float = 0.0
    speed: float = 1.0
    repeat: Optional[int] = 0  # extra passes; None = forever
    loop_range: Optional[tuple[int, int]] = None  # overrides buffer's
    start_time: int = 0  # absolute output frame
    fade_in_secs: float = 0.0
    fade_out_secs: float = 0.05  # de-click stop fade (reference default 50 ms)
    # "default" (Hermite); "high" (sinc) comes with the play_file slice
    resampling_quality: str = "default"

    def validate(self):
        """reference: FilePlaybackOptions::validate,
        src/source/file.rs:197-217."""
        if not (self.volume >= 0.0):  # also catches NaN
            raise ParameterError(f"playback options 'volume' value is {self.volume!r}")
        if not (-1.0 <= self.panning <= 1.0):
            raise ParameterError(f"playback options 'panning' value is {self.panning!r}")
        if not (0.0 <= self.speed < float("inf")):
            raise ParameterError(f"playback options 'speed' value is {self.speed!r}")
        if self.resampling_quality == "high":
            raise NotImplementedError(
                "resampling_quality='high' (sinc) is not ported yet")
        if self.resampling_quality != "default":
            raise ValueError(
                f"unknown resampling quality {self.resampling_quality!r}")
        return self


class FileSource(Source):
    PARAMS = (VOLUME, PANNING, SPEED)
    WEIGHT = 1

    def __init__(
        self,
        buffer: AudioFileBuffer,
        options: Optional[FilePlaybackOptions] = None,
        name: Optional[str] = None,
    ):
        super().__init__(name)
        self.buffer = buffer
        self.options = (options or FilePlaybackOptions()).validate()
        self.loop_range = self.options.loop_range or buffer.loop_range
        self.loop_mode = buffer.loop_mode
        self._seeks: list[tuple[int, float]] = []  # (output frame, source frame)
        self._timelines = {}  # set by the RenderProgram that owns the node

    def seek(self, at_frame: int, to_source_frame: float):
        """Schedule a seek (reference: FilePlaybackMessage::Seek), applied at
        block granularity: the block containing ``at_frame`` starts at the
        new position."""
        self._seeks.append((int(at_frame), float(to_source_frame)))

    def _max_speed_ever(self) -> float:
        """Upper bound on the SPED parameter over the program's lifetime so
        far: initial + every scheduled event value."""
        tl = self._timelines.get(SPEED.id)
        vals = [self.options.speed]
        if tl is not None:
            vals.append(tl.initial)
            vals.extend(tl.values)
        return float(max(vals))

    def speed_bucket(self, sample_rate: int) -> int:
        ratio = self.buffer.sample_rate / sample_rate
        return rs.speed_bucket(self._max_speed_ever() * ratio)

    def lower_block_inputs(self, block_start: int, block_len: int):
        flag, pos = 0.0, 0.0
        for at, p in self._seeks:
            if block_start <= at < block_start + block_len:
                flag, pos = 1.0, p
        return {"_seek_flag": np.float32(flag), "_seek_pos": np.float32(pos)}

    def param_initials(self):
        return {
            VOLUME.id: self.options.volume,
            PANNING.id: self.options.panning,
            SPEED.id: self.options.speed,
        }
