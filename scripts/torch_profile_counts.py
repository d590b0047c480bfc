"""Device operations per block of the port's main paths on the CUDA card,
one block of each under ``torch.profiler`` (``chip_smoke.profile_block``),
repeated: for holding two checkouts' counts side by side in one call.

    python3 scripts/torch_profile_counts.py [--root CHECKOUT] [--repeat 3]

``--root`` imports ``chip_smoke`` and ``phonic_tpu_torch`` from another
checkout (say the parent commit unpacked into a git-ignored directory).
Paths: the headline graph, the mastering chain and the sampler (one
``step`` after a warm block, 131072-frame blocks), and player_rt_8192 and
the synth Player (one ``render_block`` after two).  Prints one JSON line:
path -> the device operations of each repeat.
"""

import argparse
import json
import sys
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    import chip_smoke as c
    from phonic_tpu_torch.headline import mixer_graph_program
    from phonic_tpu_torch.mastering import mastering_program
    from phonic_tpu_torch.player_rt import player_rt_player
    from phonic_tpu_torch.sampler64 import sampler_program
    from phonic_tpu_torch.synth64 import synth_player

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    progs = {"headline": mixer_graph_program(c.BLOCK, dev),
             "mastering": mastering_program(c.BLOCK, dev),
             "sampler": sampler_program(c.BLOCK, dev)}
    players = {"player": player_rt_player(device=dev),
               "synth player": synth_player(device=dev)}
    counts = {name: [] for name in (*progs, *players)}
    for _ in range(args.repeat):
        for name, prog in progs.items():
            state, _ = prog.step(prog.init_state(), prog.block_inputs(0))
            torch.cuda.synchronize()
            counts[name].append(c.profile_block(
                lambda: prog.step(state, prog.block_inputs(1))[1].cpu())[0])
        for name, player in players.items():
            player.render_block()
            player.render_block()
            torch.cuda.synchronize()
            counts[name].append(c.profile_block(player.render_block)[0])
    print(json.dumps({"root": args.root, "device": torch.cuda.get_device_name(0),
                      "counts": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
