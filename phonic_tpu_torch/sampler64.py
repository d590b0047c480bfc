"""BASELINE config 2: one 64-voice sampler with AHDSR envelopes.

The same sampler, tone buffer, envelope, random notes and velocities and
note timeline as the JAX package's benchmark configuration
``config_sampler_64`` (bench.py): 64 notes 480 frames apart over a
48000-frame mono tone, each released 400000 frames after its start.  The
sampler is named so that its node path, and with it its render state,
lines up between the two packages.
"""

from __future__ import annotations

import numpy as np

from .config import EngineConfig
from .generators.base import GeneratorPlaybackOptions
from .generators.sampler import AhdsrConfig, Sampler
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .headline import SAMPLE_RATE, tone

VOICES = 64


def sampler_graph(transpose: int = 0) -> Mixer:
    """The sampler and its notes, each moved by ``transpose`` semitones
    (within MIDI's 0-127)."""
    main = Mixer("main")
    s = Sampler(tone(), GeneratorPlaybackOptions(voices=VOICES),
                envelope=AhdsrConfig(attack=0.01, decay=0.3, sustain=0.6,
                                     release=0.4), name="sampler")
    rng = np.random.default_rng(0)
    for k in range(VOICES):
        t = k * 480
        note = int(np.clip(rng.integers(36, 84) + transpose, 0, 127))
        nid = s.note_on(note, float(rng.uniform(0.4, 1.0)), time=t)
        s.note_off(nid, time=t + 400000)  # held across the first 3 blocks
    main.add_source(s)
    return main


def sampler_program(block_frames: int = 131072, device=None,
                    transpose: int = 0) -> RenderProgram:
    """The sampler as a program at 48 kHz stereo, on the config's device,
    the CUDA card, unless ``device`` says otherwise; ``transpose`` moves
    its notes (:func:`sampler_graph`)."""
    config = EngineConfig(sample_rate=SAMPLE_RATE, block_frames=block_frames)
    return RenderProgram(sampler_graph(transpose), config, device=device)
