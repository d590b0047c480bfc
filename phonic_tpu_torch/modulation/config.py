"""Generalized modulation configuration.

Behavioural spec: reference src/modulation.rs:22-155 — a ModulationConfig
declares an arbitrary list of sources (Lfo / Envelope / Velocity /
Keytracking, each with its own FourCC id and parameter descriptors) and a
list of modulatable target parameter ids.  Generators own one matrix per
voice (src/modulation/matrix.rs:105-118); routing edits never recompile
here because routings lower to dense [S, T] amount/polarity tensors
(matrix.py).

Source kinds and polarity (src/modulation.rs:95-102): Lfo is bipolar;
Envelope / Velocity / Keytracking are unipolar.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

from ..params import EnumParameter, ExponentialScaling, FloatParameter

LFO_WAVEFORMS = ("Sine", "Triangle", "Ramp Up", "Ramp Down", "Square",
                 "Random", "Smooth Random")


def _fourcc(s: str) -> str:
    if len(s) != 4:
        raise ValueError(f"FourCC id must be 4 chars, got {s!r}")
    return s


@dataclasses.dataclass(frozen=True)
class LfoSource:
    """LFO slot (reference: ModulationSource::Lfo, src/modulation.rs:23-29).

    ``rate_param``/``wave_param`` are the FourCC ids of the generated
    parameter descriptors (default: ``M<i>R`` style ids derived from the
    source id's last character, matching the sampler's ML1R/ML1W naming)."""

    id: str
    name: str = "LFO"
    rate: float = 1.0
    waveform: str = "Sine"
    rate_param: str = None
    wave_param: str = None

    bipolar = True

    def __post_init__(self):
        _fourcc(self.id)
        tag = self.id[-1]
        if self.rate_param is None:
            object.__setattr__(self, "rate_param", f"ML{tag}R")
        if self.wave_param is None:
            object.__setattr__(self, "wave_param", f"ML{tag}W")

    def parameters(self):
        return (
            FloatParameter(_fourcc(self.rate_param), f"{self.name} Rate",
                           0.01, 20.0, self.rate, unit="Hz", smoothing=None),
            EnumParameter(_fourcc(self.wave_param), f"{self.name} Waveform",
                          LFO_WAVEFORMS, self.waveform),
        )


@dataclasses.dataclass(frozen=True)
class EnvelopeSource:
    """AHDSR envelope slot (reference: ModulationSource::Envelope,
    src/modulation.rs:30-39; AHDSR processor src/modulation/processor.rs:
    22-36).  Unipolar; restarts at note-on, releases at note-off.

    Parameter FourCCs derive from ``prefix`` (3 chars) + A/H/D/S/R, e.g.
    prefix "ME1" -> ME1A, ME1H, ME1D, ME1S, ME1R."""

    id: str
    name: str = "Envelope"
    prefix: str = None
    attack: float = 0.01
    hold: float = 0.0
    decay: float = 0.0
    sustain: float = 1.0
    release: float = 0.2

    bipolar = False

    def __post_init__(self):
        _fourcc(self.id)
        if self.prefix is None:
            object.__setattr__(self, "prefix", "ME" + self.id[-1])
        if len(self.prefix) != 3:
            raise ValueError(f"envelope prefix must be 3 chars, got {self.prefix!r}")

    def parameters(self):
        p = self.prefix
        mk = lambda c, nm, dflt, hi=10.0: FloatParameter(
            p + c, f"{self.name} {nm}", 0.0, hi, dflt, unit="s" if hi == 10.0 else None,
            scaling=ExponentialScaling(3.0) if hi == 10.0 else None,
            smoothing=None)
        return (
            mk("A", "Attack", self.attack),
            mk("H", "Hold", self.hold),
            mk("D", "Decay", self.decay),
            FloatParameter(p + "S", f"{self.name} Sustain", 0.0, 1.0,
                           self.sustain, smoothing=None),
            mk("R", "Release", self.release),
        )


@dataclasses.dataclass(frozen=True)
class VelocitySource:
    """Note velocity, static per note (src/modulation.rs:40-41)."""

    id: str = "VELM"
    name: str = "Velocity"

    bipolar = False

    def parameters(self):
        return ()


@dataclasses.dataclass(frozen=True)
class KeytrackingSource:
    """note/127, static per note (src/modulation.rs:42-43)."""

    id: str = "KEYM"
    name: str = "Keytracking"

    bipolar = False

    def parameters(self):
        return ()


ModSource = Union[LfoSource, EnvelopeSource, VelocitySource, KeytrackingSource]


@dataclasses.dataclass(frozen=True)
class ModulationConfig:
    """Available sources and target parameter ids for one generator
    (reference: ModulationConfig, src/modulation.rs:135-155)."""

    sources: Tuple[ModSource, ...]
    targets: Tuple[str, ...]

    def __post_init__(self):
        ids = [s.id for s in self.sources]
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate modulation source ids: {ids}")
        if len(set(self.targets)) != len(self.targets):
            raise ValueError(f"duplicate modulation targets: {self.targets}")

    @property
    def source_ids(self):
        return tuple(s.id for s in self.sources)

    def source_parameters(self):
        out = []
        for s in self.sources:
            out.extend(s.parameters())
        return tuple(out)


# the sampler's stock config (reference: Sampler::modulation_config,
# src/generator/sampler.rs:362-427): LFO1/LFO2 + velocity + keytracking
# over the 7 granular targets
def default_sampler_config() -> ModulationConfig:
    from .matrix import TARGETS

    return ModulationConfig(
        sources=(
            LfoSource("LFO1", "LFO 1", rate=1.0),
            LfoSource("LFO2", "LFO 2", rate=2.0),
            VelocitySource(),
            KeytrackingSource(),
        ),
        targets=TARGETS,
    )
