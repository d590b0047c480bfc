"""Parameter descriptor system (host-side control plane).

Behavioural spec: reference src/parameter.rs (descriptor-not-value design,
:58-70), src/parameter/{float,integer,enum,boolean}.rs (typed descriptors),
src/parameter/scaling.rs (Linear/Exponential/Decibel/Sigmoid normalisation)
and src/parameter/formatters.rs (display strings).

Descriptors are static Python objects addressed by FourCC ids; *values* live
on-device as smoothed per-block ramps (see events.py).  normalize/denormalize
run on the host (UI/automation edge) in plain Python floats.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence, Union

from .errors import ParameterError

MINUS_INF_DB = -200.0


def db_to_linear(db: float) -> float:
    if db == 0.0:
        return 1.0
    if db > MINUS_INF_DB:
        return math.exp(db * math.log(10.0) / 20.0)
    return 0.0


def linear_to_db(v: float) -> float:
    if v == 1.0:
        return 0.0
    if v > 1e-12:
        return math.log(v) * 20.0 / math.log(10.0)
    return MINUS_INF_DB


# ---------------------------------------------------------------------------
# Scaling (reference: src/parameter/scaling.rs:10-125)
# ---------------------------------------------------------------------------


class Scaling:
    def scale(self, x: float) -> float:  # normalized -> curved normalized
        raise NotImplementedError

    def unscale(self, y: float) -> float:
        raise NotImplementedError


class LinearScaling(Scaling):
    def scale(self, x):
        return x

    def unscale(self, y):
        return y


@dataclasses.dataclass(frozen=True)
class ExponentialScaling(Scaling):
    """y = x^factor; 2..3 typical for Hz ranges."""

    factor: float

    def __post_init__(self):
        if self.factor <= 0.0:
            raise ParameterError("exponential scaling factor must be > 0")

    def scale(self, x):
        return x**self.factor

    def unscale(self, y):
        return y ** (1.0 / max(abs(self.factor), 0.001))


@dataclasses.dataclass(frozen=True)
class DecibelScaling(Scaling):
    """Maps normalized to [min_db, max_db] then to a 0-1 position in the
    linear-gain range; internal values are linear gains."""

    min_db: float
    max_db: float

    def __post_init__(self):
        if self.min_db >= self.max_db:
            raise ParameterError("decibel scaling needs min_db < max_db")

    def scale(self, x):
        db = self.min_db + x * (self.max_db - self.min_db)
        lo, hi = db_to_linear(self.min_db), db_to_linear(self.max_db)
        return (db_to_linear(db) - lo) / (hi - lo)

    def unscale(self, y):
        lo, hi = db_to_linear(self.min_db), db_to_linear(self.max_db)
        db = linear_to_db(lo + y * (hi - lo))
        return (db - self.min_db) / (self.max_db - self.min_db)


@dataclasses.dataclass(frozen=True)
class SigmoidScaling(Scaling):
    steepness: float

    def __post_init__(self):
        if self.steepness <= 0.0:
            raise ParameterError("sigmoid steepness must be > 0")

    def _sig(self, x):
        return 1.0 / (1.0 + math.exp(-self.steepness * (x - 0.5)))

    def scale(self, x):
        lo, hi = self._sig(0.0), self._sig(1.0)
        return (self._sig(x) - lo) / (hi - lo)

    def unscale(self, y):
        lo, hi = self._sig(0.0), self._sig(1.0)
        v = min(max(y * (hi - lo) + lo, 1e-4), 1.0 - 1e-4)
        return 0.5 - math.log(1.0 / v - 1.0) / self.steepness


# ---------------------------------------------------------------------------
# Formatters (reference: src/parameter/formatters.rs)
# ---------------------------------------------------------------------------


def format_percent(v: float) -> str:
    return f"{v * 100.0:.1f} %"


def format_gain(v: float) -> str:
    db = linear_to_db(v)
    return "-INF dB" if db <= MINUS_INF_DB else f"{db:.2f} dB"


def format_db(v: float) -> str:
    return f"{v:.2f} dB"


def format_pan(v: float) -> str:
    if abs(v) < 1e-3:
        return "center"
    side = "L" if v < 0 else "R"
    return f"{abs(v) * 100.0:.0f}% {side}"


def format_ratio(v: float) -> str:
    return f"{v:.1f}:1"


def format_degrees(v: float) -> str:
    return f"{v:.0f}°"


# ---------------------------------------------------------------------------
# Descriptors
# ---------------------------------------------------------------------------


def _check_fourcc(pid: str):
    if len(pid) != 4:
        raise ParameterError(f"parameter id must be a FourCC, got {pid!r}")


@dataclasses.dataclass(frozen=True)
class FloatParameter:
    """reference: src/parameter/float.rs:42-80."""

    id: str
    name: str
    min: float
    max: float
    default: float
    unit: str = ""
    scaling: Scaling = dataclasses.field(default_factory=LinearScaling)
    formatter: Optional[Callable[[float], str]] = None
    # how the live value is smoothed on-device: "exponential" (inertia,
    # default 1/256), "linear" (step), "spring" (duration samples @44.1k),
    # or None = stepped (reference: src/parameter/smoothed.rs)
    smoothing: Optional[str] = "exponential"
    smoothing_arg: Optional[float] = None

    def __post_init__(self):
        _check_fourcc(self.id)
        if not (self.min <= self.default <= self.max):
            raise ParameterError(f"{self.id}: default outside range")

    def clamp(self, v: float) -> float:
        return min(max(float(v), self.min), self.max)

    def normalize(self, v: float) -> float:
        x = (self.clamp(v) - self.min) / (self.max - self.min)
        return self.scaling.unscale(x)

    def denormalize(self, n: float) -> float:
        n = min(max(float(n), 0.0), 1.0)
        return self.min + self.scaling.scale(n) * (self.max - self.min)

    def display(self, v: float) -> str:
        if self.formatter:
            return self.formatter(v)
        return f"{v:.3f} {self.unit}".strip()


@dataclasses.dataclass(frozen=True)
class IntegerParameter:
    id: str
    name: str
    min: int
    max: int
    default: int
    unit: str = ""
    smoothing: Optional[str] = None

    def __post_init__(self):
        _check_fourcc(self.id)

    def clamp(self, v) -> int:
        return int(min(max(int(round(v)), self.min), self.max))

    def normalize(self, v) -> float:
        return (self.clamp(v) - self.min) / max(self.max - self.min, 1)

    def denormalize(self, n: float) -> int:
        return self.clamp(self.min + n * (self.max - self.min))

    def display(self, v) -> str:
        return f"{self.clamp(v)} {self.unit}".strip()


@dataclasses.dataclass(frozen=True)
class EnumParameter:
    id: str
    name: str
    values: Sequence[str]
    default: str
    smoothing: Optional[str] = None

    def __post_init__(self):
        _check_fourcc(self.id)
        if self.default not in self.values:
            raise ParameterError(f"{self.id}: default {self.default!r} not in values")

    def index_of(self, v: Union[str, int]) -> int:
        if isinstance(v, str):
            try:
                return list(self.values).index(v)
            except ValueError:
                raise ParameterError(f"{self.id}: unknown enum value {v!r}") from None
        return int(min(max(int(v), 0), len(self.values) - 1))

    def clamp(self, v):
        return self.index_of(v)

    def normalize(self, v) -> float:
        return self.index_of(v) / max(len(self.values) - 1, 1)

    def denormalize(self, n: float):
        return int(round(n * (len(self.values) - 1)))

    def display(self, v) -> str:
        return self.values[self.index_of(v)]


@dataclasses.dataclass(frozen=True)
class BooleanParameter:
    id: str
    name: str
    default: bool = False
    smoothing: Optional[str] = None

    def __post_init__(self):
        _check_fourcc(self.id)

    def clamp(self, v) -> float:
        return 1.0 if v else 0.0

    def normalize(self, v) -> float:
        return 1.0 if v else 0.0

    def denormalize(self, n: float) -> bool:
        return n >= 0.5

    def display(self, v) -> str:
        return "on" if v else "off"


Parameter = Union[FloatParameter, IntegerParameter, EnumParameter, BooleanParameter]
