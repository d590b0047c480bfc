"""The glide and seek traffic (``traffic/lanes_divergent.json``), which no
cell of ``BENCHMARK.json`` drives yet (§7 of PERF.md), rendered on the CPU
at a small size against the reference: the generator's glides and seeks,
the configuration's glide and seek targets and the reference's glides stay
exercised until the cell returns.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import bench  # noqa: E402
from harness.check import compare, reference_blocks  # noqa: E402
from harness.entries import ENTRIES  # noqa: E402
from harness.traffic import Traffic  # noqa: E402

# sound CPU renders read -113..-120 dB; the bfloat16 control, over -10
LIMIT_DB = -60.0
BLOCKS = 3


def _setup(seed):
    cfg = bench.module("configs", "mixer_graph_16src")
    cfg.CONFIG.update(getattr(cfg, "CPU_REHEARSAL", {}))
    # a glide and a seek in about every block, not every 10 audio-seconds
    mix = dict(bench.data("traffic", "lanes_divergent"), block_frames=16384,
               lanes=2, glides_per_audio_s=3.0, seeks_per_audio_s=3.0)
    spec = cfg.spec(seed)
    return cfg, mix, spec


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 2 ** 32 + 5])
def test_glides_and_seeks_match_reference(seed):
    cfg, mix, spec = _setup(seed)
    entry = ENTRIES[mix["entry"]](cfg, spec, mix, Traffic(
        mix, cfg, spec, seed, mix["lanes"]), "cpu")
    while entry.block < BLOCKS:
        entry.step()
    kinds = {ev[0] for blk in entry.log for lane in blk for ev in lane}
    assert {"glide", "seek", "set"} <= kinds
    err, per = compare(cfg, spec, mix, entry.log, entry.audio, "cpu")
    assert err <= LIMIT_DB, per


def test_glide_control_fails():
    seed = 2 ** 31 + 13
    cfg, mix, spec = _setup(seed)
    tr = Traffic(mix, cfg, spec, seed, mix["lanes"])
    log = [[tr.events(lane, b) for lane in range(mix["lanes"])]
           for b in range(BLOCKS)]
    audio = [a.float().numpy() for a in reference_blocks(
        cfg, spec, mix, log, BLOCKS, "cpu", torch.bfloat16)]
    err, _ = compare(cfg, spec, mix, log, audio, "cpu")
    assert err > LIMIT_DB
