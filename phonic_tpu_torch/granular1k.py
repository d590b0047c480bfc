"""BASELINE config 4: about a thousand concurrent grains.

The same sampler, tone, granular settings and notes as the JAX package's
benchmark configuration ``config_granular_1k`` (bench.py): one sampler with
10 voices over a 96000-frame mono tone, grains of 1000 ms at 100 Hz density
(so each voice keeps its 100-grain pool full), notes 48..57 at volume 0.3,
37 frames apart.  The sampler is named so that its node path, and with it
its render state, lines up between the two packages.
"""

from __future__ import annotations

from .config import EngineConfig
from .generators.base import GeneratorPlaybackOptions
from .generators.granular import GranularConfig
from .generators.sampler import Sampler
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .headline import SAMPLE_RATE, tone

VOICES = 10


def granular_graph() -> Mixer:
    main = Mixer("main")
    s = Sampler(tone(frames=96000), GeneratorPlaybackOptions(voices=VOICES),
                name="sampler").with_granular_playback(GranularConfig(
                    size_ms=1000.0, density_hz=100.0, position=0.3,
                    variation=0.5, spray=0.3, pan_spread=0.8))
    for v in range(VOICES):
        s.note_on(48 + v, volume=0.3, time=v * 37)
    main.add_source(s)
    return main


def granular_program(block_frames: int = 131072, device=None) -> RenderProgram:
    """The granular sampler as a program at 48 kHz stereo, on the config's
    device, the CUDA card, unless ``device`` says otherwise."""
    config = EngineConfig(sample_rate=SAMPLE_RATE, block_frames=block_frames)
    return RenderProgram(granular_graph(), config, device=device)
