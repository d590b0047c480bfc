"""The synth path at full width, ``synth_64v``: a 64-voice synth generator,
a bank of 16 synth sources and the filter and pan effects.

The synth counterpart of bench.py's config 2 (``config_sampler_64``), at
the same width: ``SynthGenerator(synths.sub3(), voices=64,
release_secs=0.3)`` takes config 2's notes (64 notes 480 frames apart,
pitches and velocities from ``np.random.default_rng(0)``, each held 400000
frames); 16 ``SynthSource``s share one ``synths.dx7()`` SynthDef, so they
render as one bank, 110 to 880 Hz, starting 4800 frames apart, each
200000 frames long, in a sub-mixer that runs ``FilterEffect("Lowpass",
4000.0, 0.707)``; the master runs ``PanningEffect(pan=0.2, width=1.2)``.
Every node is named, so its path lines up with the same graph built from
the JAX package (``notes`` and ``BANK_FREQS`` give its schedule).
``synth_player`` plays the same graph live through a ``Player``, with
``play_generator`` and ``play_synth``.
"""

from __future__ import annotations

import numpy as np

from . import synths
from .config import EngineConfig
from .effects.filter import FilterEffect
from .effects.pan import PanningEffect
from .generators.base import GeneratorPlaybackOptions
from .generators.synth import SynthGenerator
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .headline import SAMPLE_RATE
from .outputs.null import NullOutput
from .player import Player, PlayerConfig
from .sources.synth import SynthPlaybackOptions, SynthSource

VOICES = 64
SOURCES = 16
BANK_FREQS = tuple(float(f) for f in np.linspace(110.0, 880.0, SOURCES))
BANK_START = 4800  # frames between the bank's source starts
BANK_FRAMES = 200000  # each source's gate length
HOLD = 400000  # frames each generator note is held


def notes():
    """(time, note, velocity) of the generator's 64 notes: bench.py's
    config 2 schedule."""
    rng = np.random.default_rng(0)
    return [(k * 480, int(rng.integers(36, 84)), float(rng.uniform(0.4, 1.0)))
            for k in range(VOICES)]


def synth_generator() -> SynthGenerator:
    gen = SynthGenerator(synths.sub3(), GeneratorPlaybackOptions(voices=VOICES),
                         release_secs=0.3, name="synth")
    for t, note, vel in notes():
        nid = gen.note_on(note, vel, time=t)
        gen.note_off(nid, time=t + HOLD)  # held across the first 3 blocks
    return gen


def bank_options():
    """The bank's sources' playback options, in order."""
    return [SynthPlaybackOptions(frequency=freq, start_time=k * BANK_START,
                                 duration=BANK_FRAMES, volume=0.25)
            for k, freq in enumerate(BANK_FREQS)]


def synth_graph() -> Mixer:
    main = Mixer("main")
    main.add_source(synth_generator())
    bank = main.add_mixer(Mixer("bank"))
    dx7 = synths.dx7()
    for k, options in enumerate(bank_options()):
        bank.add_source(SynthSource(dx7, options, name=f"tone{k}"))
    bank.add_effect(FilterEffect("Lowpass", 4000.0, 0.707, name="filter"))
    main.add_effect(PanningEffect(pan=0.2, width=1.2, name="pan"))
    return main


def synth_program(block_frames: int = 131072, device=None) -> RenderProgram:
    """The synth path as a program at 48 kHz stereo, on the config's
    device, the CUDA card, unless ``device`` says otherwise."""
    config = EngineConfig(sample_rate=SAMPLE_RATE, block_frames=block_frames)
    return RenderProgram(synth_graph(), config, device=device)


def synth_player(block_frames: int = 8192, device=None) -> Player:
    """The same graph in a ``Player`` (metering and auto-bypass on), on the
    CUDA card unless ``device`` says otherwise, writing to a NullOutput:
    the generator through ``play_generator``, the bank through
    ``play_synth`` into a sub-mixer with the filter, the pan on the
    master."""
    player = Player(NullOutput(SAMPLE_RATE, 2),
                    PlayerConfig(block_frames=block_frames), device=device)
    player.play_generator(synth_generator())
    bank = player.add_mixer()
    dx7 = synths.dx7()
    for options in bank_options():
        player.play_synth(dx7, options, mixer=bank.mixer)
    bank.add_effect(FilterEffect("Lowpass", 4000.0, 0.707))
    player.add_effect(PanningEffect(pan=0.2, width=1.2))
    return player
