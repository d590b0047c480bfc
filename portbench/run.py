"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells are in ``BENCHMARK.json`` at the root of the checkout.  The run
needs a CUDA card (as many as the cell asks for): without one it exits
with code 2 and prints no result.  With ``--trace 0`` the result holds the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics, read
from a ``torch.profiler`` window.  The last line of standard output is one
JSON object; the numbers of the correctness check also end standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    root = Path(__file__).resolve().parent.parent
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from harness import bench as harness
    result, lines = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), T_START)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
