"""Mixer-graph stress rig: the analog of reference
examples/play-multi-threaded.rs (the de-facto benchmark harness):
configurable sub-mixers x sources x effects with a seeded RNG; port of
``examples/play_graph.py``."""

import time

import numpy as np

from .. import FilePlaybackOptions
from ..effects.chorus import ChorusEffect
from ..effects.eq5 import Eq5Effect
from ..effects.filter import FilterEffect
from ..effects.reverb import ReverbEffect
from .common import demo_buffer, make_parser, make_player


def main():
    p = make_parser("mixer graph stress rig")
    p.add_argument("--submixers", type=int, default=4)
    p.add_argument("--sources-per-mixer", type=int, default=4)
    p.add_argument("--effects-per-mixer", type=int, default=2)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=4.0)
    args = p.parse_args()
    rng = np.random.default_rng(args.seed)
    player = make_player(args)
    sr = args.sample_rate

    effect_pool = [
        lambda: Eq5Effect(gains=list(rng.uniform(-6, 6, 5))),
        lambda: ChorusEffect(rate=float(rng.uniform(0.2, 3.0))),
        lambda: FilterEffect(cutoff=float(rng.uniform(500, 8000))),
        lambda: ReverbEffect(room_size=float(rng.uniform(0.3, 0.8)), wet=0.25),
    ]
    for m in range(args.submixers):
        sub = player.add_mixer()
        for s in range(args.sources_per_mixer):
            buf = demo_buffer(sr, freq=float(rng.uniform(80, 700)),
                              secs=float(rng.uniform(0.5, 2.0)))
            player.play_file(buf, FilePlaybackOptions(
                volume=float(rng.uniform(0.2, 0.7)),
                panning=float(rng.uniform(-0.9, 0.9)),
                speed=float(rng.uniform(0.5, 2.0)),
                repeat=None,
                start_time=int(rng.uniform(0, sr)),
            ), mixer=sub.mixer)
        for e in range(args.effects_per_mixer):
            sub.add_effect(effect_pool[int(rng.integers(len(effect_pool)))]())

    t0 = time.perf_counter()
    player.run(duration_frames=int(args.seconds * sr))
    dt = time.perf_counter() - t0
    print(player)
    print(f"{args.seconds:.1f}s of audio in {dt:.2f}s = "
          f"{args.seconds / dt:.1f}x realtime")
    player.close()


if __name__ == "__main__":
    main()
