"""phonic_tpu_torch — the PyTorch + CUDA port of phonic_tpu.

A batched audio rendering engine: a mixer graph of file sources, samplers,
sub-mixers and effect chains renders block by block on one device.  Programs render on
the CUDA card unless asked for the CPU (``device="cpu"``).  On the card the
source reads, the recursive filters and the dynamics recurrences run
hand-written Hopper kernels (``csrc/``); on the CPU the same functions run
their plain PyTorch versions.  The JAX package ``phonic_tpu`` is the
reference this port is tested against; this package never imports it.
"""

from .config import DEFAULT_CONFIG, EngineConfig
from .effects.compressor import CompressorEffect
from .effects.delay import DelayEffect
from .effects.distortion import DistortionEffect
from .effects.gate import GateEffect
from .errors import (
    MediaFileError, NotFoundError, ParameterError, PhonicError,
)
from .generators.base import Generator, GeneratorPlaybackOptions
from .generators.sampler import AhdsrConfig, Sampler
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .io.decoder import AudioFileBuffer
from .mastering import mastering_chain, mastering_program
from .sampler64 import sampler_graph, sampler_program
from .sources.file import FilePlaybackOptions, FileSource

__all__ = [
    "DEFAULT_CONFIG", "EngineConfig", "MediaFileError", "NotFoundError",
    "ParameterError", "PhonicError", "RenderProgram", "Mixer",
    "AudioFileBuffer", "FilePlaybackOptions", "FileSource",
    "CompressorEffect", "DelayEffect", "DistortionEffect", "GateEffect",
    "mastering_chain", "mastering_program", "Generator",
    "GeneratorPlaybackOptions", "AhdsrConfig", "Sampler", "sampler_graph",
    "sampler_program",
]
