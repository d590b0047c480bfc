"""The headline mixer graph: 16 file sources -> 4 sub-mixers with EQ5 and
chorus -> master reverb and gain.

The same topology, seeds, random draws and tone buffers as the JAX
package's benchmark configuration ``config_mixer_graph`` (bench.py), with
explicit node names so that node paths, and with them render states, line
up between the two packages.
"""

from __future__ import annotations

import numpy as np

from .config import EngineConfig
from .effects.chorus import ChorusEffect
from .effects.eq5 import Eq5Effect
from .effects.gain import GainEffect
from .effects.reverb import ReverbEffect
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .io.decoder import AudioFileBuffer
from .sources.file import FilePlaybackOptions, FileSource

SAMPLE_RATE = 48000
SOURCES = 16
SUBMIXERS = 4


def tone(frames=48000, freq=220.0, sr=SAMPLE_RATE, decay=2.0) -> AudioFileBuffer:
    """A decaying mono sine, as bench.py's ``_tone``."""
    t = np.arange(frames) / sr
    x = (0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * decay)).astype(np.float32)
    return AudioFileBuffer.from_array(x[None, :], sr)


def mixer_graph() -> Mixer:
    rng = np.random.default_rng(0)
    main = Mixer("main")
    subs = [main.add_mixer(Mixer(f"sub{i}")) for i in range(SUBMIXERS)]
    for i in range(SOURCES):
        buf = tone(frames=12000 + 977 * i, freq=float(rng.uniform(80, 660)))
        subs[i % SUBMIXERS].add_source(FileSource(buf, FilePlaybackOptions(
            volume=float(rng.uniform(0.2, 0.6)),
            panning=float(rng.uniform(-0.8, 0.8)),
            speed=float(rng.uniform(0.5, 2.0)), repeat=None), name=f"src{i}"))
    for s in subs:
        s.add_effect(Eq5Effect(gains=list(rng.uniform(-6, 6, 5)), name="eq"))
        s.add_effect(ChorusEffect(rate=float(rng.uniform(0.3, 2.0)),
                                  name="chorus"))
    main.add_effect(ReverbEffect(room_size=0.6, wet=0.2, min_room_size=0.55,
                                 name="reverb"))
    main.add_effect(GainEffect(gain=0.8, name="gain"))
    return main


def mixer_graph_program(block_frames: int = 131072,
                        device="cuda") -> RenderProgram:
    """The headline graph as a program at 48 kHz stereo, on the CUDA card
    unless ``device`` says otherwise."""
    config = EngineConfig(sample_rate=SAMPLE_RATE, block_frames=block_frames)
    return RenderProgram(mixer_graph(), config, device=device)
