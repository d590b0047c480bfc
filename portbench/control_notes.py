"""The control of the correctness check for a cell whose entry draws notes
(``harness/notes.py``): ``control.py``'s reading, with the notes the entry
would schedule added to the traffic's events.

    python3 portbench/control_notes.py --workload <cell> --seeds 1 2 3 \
        [--blocks 16]

Runs on the CUDA card at the cell's own size; prints, per seed, the
control's ``err_db`` (the plain reference in bfloat16 judged by the cell's
comparison) beside the cell's limit and the control's best block.
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
from harness.notes import note_log  # noqa: E402
from harness.traffic import Traffic  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--blocks", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    wl = next(w for w in harness.benchmark()["workloads"]
              if w["name"] == args.workload)
    cfg = harness.module("configs", wl["config"])
    mix = harness.data("traffic", wl["traffic"])
    limit = harness.data("limits", args.workload)["err_db"]
    lanes = mix["lanes"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        spec = cfg.spec(seed)
        log = note_log(mix, Traffic(mix, cfg, spec, seed, lanes), lanes,
                       args.blocks, spec["sample_rate"], cfg.NOTE_TARGET)
        audio = [a.float().cpu().numpy() for a in reference_blocks(
            cfg, spec, mix, log, args.blocks, "cuda", torch.bfloat16)]
        err, per = compare(cfg, spec, mix, log, audio, "cuda")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "blocks": args.blocks, "control_err_db": err,
                          "best_block_err_db": min(min(r) for r in per),
                          "limit": limit, "fails": not err <= limit,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
