"""The benchmark's correctness check fails where it must, at sizes a test
run holds on the CPU (the kernels' plain versions):

* the control (the reference in bfloat16, one precision below the
  engine's float32) reads over every cell's limit;
* a run whose timed path is broken underneath reads ``correct`` false,
  for each fault a cell can have: a step that returns its state
  unchanged, half of a batch of lanes left out, and one block's answer
  altered where it is produced.  (No cell spans chips, so none can leave
  out an exchange between them.)

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from harness import bench  # noqa: E402
from control import control_reading  # noqa: E402

CELLS = [w["name"] for w in bench.benchmark()["workloads"]]


def _small(cell):
    wl = next(w for w in bench.benchmark()["workloads"] if w["name"] == cell)
    mix = bench.data("traffic", wl["traffic"])
    over = {"block_frames": min(mix["block_frames"], 16384)}
    if mix["entry"] == "lanes":
        over["lanes"] = 2
    if mix["entry"] == "player":
        over = {"block_frames": 4096, "chunk_blocks": 4}
    return mix, over


def _run(cell):
    _, over = _small(cell)
    result, _ = bench.run(cell, 2 ** 31 + 4242, 1.0, False,
                          time.perf_counter(), device="cpu", overrides=over)
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    _, over = _small(cell)
    err = control_reading(cell, 2 ** 31 + 7, 3, "cpu", over)
    assert err > bench.data("limits", cell)["err_db"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"]


def _wrap(monkeypatch, cls, name, fn):
    orig = getattr(cls, name)
    monkeypatch.setattr(cls, name, lambda self, *a: fn(orig, self, *a))


def _patch(monkeypatch, cell, fault):
    """Break the timed entry the cell calls."""
    from phonic_tpu_torch.graph.engine import RenderProgram
    from phonic_tpu_torch.parallel.mesh import BatchedRenderProgram
    mix, _ = _small(cell)
    lanes = mix["entry"] == "lanes"
    cls, name = ((BatchedRenderProgram, "step") if lanes
                 else (RenderProgram, "step_packed"))
    calls = []

    def broken(orig, self, state, inputs):
        new, out = orig(self, state, inputs)
        calls.append(1)
        audio = out[0] if isinstance(out, tuple) else out
        if fault == "state_unchanged":
            return state, out
        if fault == "half_batch":
            audio[audio.shape[0] // 2:] = 0.0
        if fault == "answer_altered" and len(calls) == 2:
            # one block of every lane gets noise at a third of its RMS
            g = torch.Generator().manual_seed(1)
            audio += 0.3 * audio.square().mean().sqrt() * torch.randn(
                audio.shape, generator=g).to(audio.device)
        return new, out

    _wrap(monkeypatch, cls, name, broken)


FAULTS = [(c, f) for c in CELLS for f in ("state_unchanged", "half_batch",
                                          "answer_altered")
          if f != "half_batch" or _small(c)[0]["entry"] == "lanes"]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(monkeypatch, cell, fault):
    _patch(monkeypatch, cell, fault)
    result = _run(cell)
    assert not result["correct"]
    assert result["failed"] > 0
    assert np.isfinite(result["check"]["err_db"]["value"]) or \
        result["check"]["err_db"]["value"] > 0
