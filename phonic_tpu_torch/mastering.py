"""The mastering chain: 4 looping file sources -> one master bus running
gate -> compressor -> delay -> distortion -> limiter.

The same topology, seeds, random draws and tone buffers as the JAX
package's benchmark configuration ``config_mastering`` (bench.py), with
explicit node names so that node paths, and with them render states, line
up between the two packages.
"""

from __future__ import annotations

import numpy as np

from .config import EngineConfig
from .effects.compressor import CompressorEffect
from .effects.delay import DelayEffect
from .effects.distortion import DistortionEffect
from .effects.gate import GateEffect
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .headline import SAMPLE_RATE, tone
from .sources.file import FilePlaybackOptions, FileSource

SOURCES = 4


def mastering_chain() -> Mixer:
    rng = np.random.default_rng(0)
    main = Mixer("main")
    for i in range(SOURCES):
        main.add_source(FileSource(
            tone(freq=float(rng.uniform(100, 500))),
            FilePlaybackOptions(volume=0.4, repeat=None), name=f"src{i}"))
    main.add_effect(GateEffect(threshold=-40.0, name="gate"))
    main.add_effect(CompressorEffect(threshold=-12.0, ratio=4.0, name="comp"))
    # capacity hints: the chain never automates the delay below 250 ms or
    # above 1 s, so the window stays short and the feedback sub-block large
    main.add_effect(DelayEffect(delay_ms=300.0, feedback=0.4, wet=0.3,
                                min_delay_ms=250.0,
                                max_delay_capacity_ms=1000.0, name="delay"))
    main.add_effect(DistortionEffect("Diode", drive=1.0, mix=0.3, name="dist"))
    main.add_effect(CompressorEffect.limiter(name="limiter"))
    return main


def mastering_program(block_frames: int = 131072,
                      device="cuda") -> RenderProgram:
    """The mastering chain as a program at 48 kHz stereo, on the CUDA card
    unless ``device`` says otherwise."""
    config = EngineConfig(sample_rate=SAMPLE_RATE, block_frames=block_frames)
    return RenderProgram(mastering_chain(), config, device=device)
