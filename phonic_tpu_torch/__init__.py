"""phonic_tpu_torch — the PyTorch + CUDA port of phonic_tpu.

A batched audio rendering engine: a mixer graph of file sources (preloaded
or streamed), samplers, synths, sub-mixers and effect chains renders block
by block on one device, one instance of the graph or many independent
lanes at once (``parallel.mesh.BatchedRenderProgram``).  Programs render on
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
from .effects.filter import FilterEffect
from .effects.gate import GateEffect
from .effects.pan import PanningEffect
from .errors import (
    MediaFileError, NotFoundError, OutputDeviceError, ParameterError,
    PhonicError, ResamplingError, SendError, UnsupportedFormatError,
)
from .generators.base import Generator, GeneratorPlaybackOptions
from .generators.granular import GranularConfig
from .generators.sampler import AhdsrConfig, Sampler
from .generators.synth import SynthGenerator
from .granular1k import granular_graph, granular_program
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .graph.nodes import Effect, Source
from .io.decoder import (
    AudioFileBuffer, AudioFileInfo, decode_file, file_info, register_decoder,
)
from .mastering import mastering_chain, mastering_program
from .modulation import (
    EnvelopeSource, KeytrackingSource, LfoSource, ModulationConfig,
    VelocitySource,
)
from .outputs.base import OutputDevice, default_output_device
from .outputs.wav_out import WavOutput
from .params import (
    BooleanParameter, DecibelScaling, EnumParameter, ExponentialScaling,
    FloatParameter, IntegerParameter, LinearScaling, Scaling, SigmoidScaling,
    db_to_linear, linear_to_db,
)
from .play_file import play_file_graph, play_file_program, render_file
from .player import (
    AudioLevel, CpuLoad, EffectHandle, GeneratorPlaybackHandle, MixerHandle,
    PlaybackHandle, PlaybackStatusEvent, Player, PlayerConfig,
)
from .sampler64 import sampler_graph, sampler_program
from .sources.empty import EmptyGenerator, EmptySource
from .sources.file import FilePlaybackOptions, FileSource
from .sources.streamed import StreamedFileSource
from .sources.synth import SynthDef, SynthPlaybackOptions, SynthSource
from . import synths
from .synth64 import synth_graph, synth_program

__all__ = [
    "DEFAULT_CONFIG", "EngineConfig", "MediaFileError", "NotFoundError",
    "ParameterError", "PhonicError", "RenderProgram", "Mixer",
    "AudioFileBuffer", "FilePlaybackOptions", "FileSource",
    "CompressorEffect", "DelayEffect", "DistortionEffect", "GateEffect",
    "mastering_chain", "mastering_program", "Generator",
    "GeneratorPlaybackOptions", "AhdsrConfig", "Sampler", "sampler_graph",
    "sampler_program", "AudioFileInfo", "decode_file", "file_info",
    "register_decoder", "UnsupportedFormatError", "WavOutput",
    "play_file_graph", "play_file_program", "render_file", "GranularConfig",
    "ModulationConfig", "LfoSource", "EnvelopeSource", "VelocitySource",
    "KeytrackingSource", "granular_graph", "granular_program", "SynthDef",
    "SynthPlaybackOptions", "SynthSource", "SynthGenerator", "synths",
    "FilterEffect", "PanningEffect", "StreamedFileSource", "EmptySource",
    "EmptyGenerator", "synth_graph", "synth_program", "OutputDeviceError",
    "ResamplingError", "SendError", "Effect", "Source", "OutputDevice",
    "default_output_device", "BooleanParameter", "DecibelScaling",
    "EnumParameter", "ExponentialScaling", "FloatParameter",
    "IntegerParameter", "LinearScaling", "Scaling", "SigmoidScaling",
    "db_to_linear", "linear_to_db", "AudioLevel", "CpuLoad", "EffectHandle",
    "GeneratorPlaybackHandle", "MixerHandle", "PlaybackHandle",
    "PlaybackStatusEvent", "Player", "PlayerConfig",
]

__version__ = "0.1.0"
