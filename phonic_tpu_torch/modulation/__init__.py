"""Modulation sources, configuration and the per-voice routing matrix."""

from .config import (  # noqa: F401
    EnvelopeSource, KeytrackingSource, LfoSource, ModulationConfig,
    VelocitySource, default_sampler_config,
)
from .matrix import ModulationRoutings  # noqa: F401
