"""The one traffic generator: a mix file (``traffic/<mix>.json``) sets the
rates, the configuration names what they act on (``knobs``,
``glide_targets``, ``seek_targets``), and the seed draws the rest.

Every block of every lane gets a fixed number of events, the same for
every seed (the seed draws which targets, when inside the block, and what
values), so a seed changes the work's order and values, not its amount.
An event is ``(kind, key, pid, frame, value, rate)``: ``set`` a parameter,
``glide`` a source's speed at ``rate`` semitones per second, or ``seek`` a
source to a source frame.
"""

from __future__ import annotations

import math

import numpy as np

GLIDE_GRID = 512  # glides start on the engine's 512-frame knot grid
GLIDE_ROOM = 8192  # and end well inside their block


def _count(rate: float, block: int, block_s: float, phase: float = 0.0) -> int:
    """Events of a steady ``rate`` per audio-second falling in ``block``."""
    if not rate:
        return 0
    return (math.floor((block + 1) * block_s * rate + phase)
            - math.floor(block * block_s * rate + phase))


class Traffic:
    def __init__(self, mix: dict, cfg, spec: dict, seed: int, lanes: int):
        self.mix, self.seed = mix, seed & (2 ** 64 - 1)
        self.cfg, self.spec = cfg, spec
        self.n = mix["block_frames"]
        self.block_s = self.n / spec["sample_rate"]
        self.knobs = cfg.knobs(spec, mix)
        self.glides = cfg.glide_targets(spec) if mix.get(
            "glides_per_audio_s") else []
        self.seeks = cfg.seek_targets(spec) if mix.get(
            "seeks_per_audio_s") else []
        self.speed = [{k: s for k, s, _ in self.glides} for _ in range(lanes)]
        if self.glides and self.n < 2 * GLIDE_ROOM:
            raise ValueError("glides need blocks of at least "
                             f"{2 * GLIDE_ROOM} frames")

    def events(self, lane: int, block: int) -> list:
        """The events of ``lane`` in ``block``, in time order per target."""
        mix, n = self.mix, self.n
        rng = np.random.default_rng([self.seed, lane, block, 0x7E])
        f0 = block * n
        out = []
        if block == 0 and hasattr(self.cfg, "lane_start") and \
                mix["entry"] == "lanes":
            out += self.cfg.lane_start(self.spec, np.random.default_rng(
                [self.seed, lane, 0xA11]))
        k = _count(mix["events_per_audio_s"], block, self.block_s)
        if k:
            picks = rng.integers(0, len(self.knobs), size=k)
            times = np.sort(rng.choice(n, size=k, replace=False))
            vals = rng.uniform(size=k)
            for i, t, u in zip(picks, times, vals):
                key, pid, lo, hi = self.knobs[i]
                out.append(("set", key, pid, f0 + int(t),
                            float(lo + (hi - lo) * u), 0.0))
        # glides and seeks come at steady rates, half a period apart
        if _count(mix.get("glides_per_audio_s", 0), block, self.block_s):
            key, _, top = self.glides[rng.integers(0, len(self.glides))]
            start = GLIDE_GRID * int(rng.integers(0, (n - GLIDE_ROOM)
                                                  // GLIDE_GRID))
            target = float(top * rng.uniform(0.55, 1.0))
            steps = abs(12.0 * math.log2(target / self.speed[lane][key]))
            rate = max(steps, 0.05) / mix["glide_seconds"]
            self.speed[lane][key] = target
            out.append(("glide", key, "SPED", f0 + start, target, rate))
        if _count(mix.get("seeks_per_audio_s", 0), block, self.block_s, 0.5):
            key, frames = self.seeks[rng.integers(0, len(self.seeks))]
            out.append(("seek", key, None, f0 + int(rng.integers(0, n)),
                        float(rng.uniform(0, frames)), 0.0))
        return out
