"""The headline graph on the card against the CPU with phase 6h's lane 7
changes taken apart: an EQ5 band at +9 dB and the chorus depth at 0.9.

    python scripts/torch_chorus_drift.py

Needs a CUDA card.  Renders 2 blocks of 131072 frames of
``mixer_graph_program`` on the card and on the CPU for each of the four
combinations and prints each block's largest difference in dB of peak,
after the card's name and power limit.  A chorus LFO whose phase
increment rounds differently on the two devices drifts with time, and
the depth scales what the drift moves.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from phonic_tpu_torch.headline import mixer_graph_program  # noqa: E402

BLOCK = 131072


def program(device, eq, depth):
    prog = mixer_graph_program(block_frames=BLOCK, device=device)
    if eq:
        prog.set_parameter("main/sub0/eq", "gan3", 9.0, at_frame=2000)
    if depth:
        prog.set_parameter("main/sub1/chorus", "dpth", 0.9, at_frame=2000)
    return prog


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    for eq, depth in ((False, False), (True, False), (False, True),
                      (True, True)):
        card = program("cuda", eq, depth).render(2 * BLOCK)
        cpu = program("cpu", eq, depth).render(2 * BLOCK)
        dbs = []
        for k in range(2):
            sl = slice(k * BLOCK, (k + 1) * BLOCK)
            dbs.append(20 * np.log10(np.abs(card[:, sl] - cpu[:, sl]).max()
                                     / np.abs(cpu[:, sl]).max()))
        print(f"eq={eq} depth={depth}: card vs CPU {dbs[0]:.1f} / "
              f"{dbs[1]:.1f} dB", flush=True)


if __name__ == "__main__":
    main()
