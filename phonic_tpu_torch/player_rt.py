"""The headline graph as the Player runs it live (bench.py's
``config_player_rt``, BASELINE ``player_rt_8192``).

The same 16 tones, options and effects as ``config_player_rt``, drawn from
the same seed in the same order: 16 file sources that play once
(``repeat=None`` ends them after 0.1-1.1 s) on 4 sub-mixers with EQ5 and
chorus, and a master reverb before the Player's own master gain; 8192-frame
blocks at 48 kHz stereo, with per-mixer metering and silence auto-bypass
on, pulled through ``Player.run``'s pipelined pump.  As the sources run
out the Player retires them 8 at a time, each retirement a rebuild that
adopts the running state.
"""

from __future__ import annotations

import numpy as np

from .effects.chorus import ChorusEffect
from .effects.eq5 import Eq5Effect
from .effects.reverb import ReverbEffect
from .headline import SAMPLE_RATE, SOURCES, SUBMIXERS, tone
from .outputs.null import NullOutput
from .player import Player, PlayerConfig
from .sources.file import FilePlaybackOptions

BLOCK_FRAMES = 8192


def player_rt_player(block_frames: int = BLOCK_FRAMES, device=None) -> Player:
    """The ``player_rt_8192`` Player on the CUDA card unless ``device``
    says otherwise, writing to a NullOutput."""
    rng = np.random.default_rng(0)
    player = Player(NullOutput(SAMPLE_RATE, 2),
                    PlayerConfig(block_frames=block_frames), device=device)
    subs = [player.add_mixer() for _ in range(SUBMIXERS)]
    for i in range(SOURCES):
        buf = tone(frames=12000 + 977 * i, freq=float(rng.uniform(80, 660)))
        player.play_file(buf, FilePlaybackOptions(
            volume=float(rng.uniform(0.2, 0.6)),
            panning=float(rng.uniform(-0.8, 0.8)),
            speed=float(rng.uniform(0.5, 2.0)), repeat=None),
            mixer=subs[i % SUBMIXERS].mixer)
    for s in subs:
        s.add_effect(Eq5Effect(gains=list(rng.uniform(-6, 6, 5))))
        s.add_effect(ChorusEffect(rate=float(rng.uniform(0.3, 2.0))))
    player.add_effect(ReverbEffect(room_size=0.6, wet=0.2))
    return player
