"""The control of the correctness check: the plain reference computed one
precision below the engine's float32 (bfloat16), put in the program's
place and judged by the same comparison.  It has to come out not correct.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \
        [--blocks 16]

Runs on the CUDA card at the cell's own size (lanes, block length, graph);
prints, per seed, the control's ``err_db`` beside the cell's limit (none
where the control crashed, which counts as failing).  The benchmark's own
runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from harness import bench as harness  # noqa: E402
from harness.check import compare, reference_blocks  # noqa: E402
from harness.traffic import Traffic  # noqa: E402


def control_reading(workload: str, seed: int, blocks: int, device: str,
                    overrides: dict = None) -> float:
    """The control's err_db on ``blocks`` blocks of the cell's traffic."""
    b = harness.benchmark()
    wl = next(w for w in b["workloads"] if w["name"] == workload)
    cfg = harness.module("configs", wl["config"])
    mix = dict(harness.data("traffic", wl["traffic"]), **(overrides or {}))
    if overrides:
        cfg.CONFIG.update(getattr(cfg, "CPU_REHEARSAL", {}))
    lanes = mix.get("lanes", 1)
    spec = cfg.spec(seed)
    tr = Traffic(mix, cfg, spec, seed, lanes)
    log = [[tr.events(lane, blk) for lane in range(lanes)]
           for blk in range(blocks)]
    audio = [a.float().cpu().numpy() for a in reference_blocks(
        cfg, spec, mix, log, blocks, device, torch.bfloat16)]
    err, _ = compare(cfg, spec, mix, log, audio, device)
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--blocks", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    limit = harness.data("limits", args.workload)["err_db"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        row = {"workload": args.workload, "seed": seed, "blocks": args.blocks}
        try:
            err = control_reading(args.workload, seed, args.blocks, "cuda")
            row.update(control_err_db=err, fails=not err <= limit)
        except RuntimeError as e:  # a control that gives no number fails
            row.update(control_err_db=None, fails=True, crashed=str(e))
        row.update(limit=limit, seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
