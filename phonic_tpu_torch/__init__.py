"""phonic_tpu_torch — the PyTorch + CUDA port of phonic_tpu.

A batched audio rendering engine: a mixer graph of file sources, sub-mixers
and effect chains renders block by block on one device.  On a CUDA device
the source reads and the recursive filters run hand-written Hopper kernels
(``csrc/``); on the CPU the same functions run their plain PyTorch
versions.  The JAX package ``phonic_tpu`` is the reference this port is
tested against; this package never imports it.
"""

from .config import DEFAULT_CONFIG, EngineConfig
from .errors import (
    MediaFileError, NotFoundError, ParameterError, PhonicError,
)
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .io.decoder import AudioFileBuffer
from .sources.file import FilePlaybackOptions, FileSource

__all__ = [
    "DEFAULT_CONFIG", "EngineConfig", "MediaFileError", "NotFoundError",
    "ParameterError", "PhonicError", "RenderProgram", "Mixer",
    "AudioFileBuffer", "FilePlaybackOptions", "FileSource",
]
