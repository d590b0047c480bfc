"""Count the tensor operations one block of a port program dispatches, on
the CPU.

    python scripts/torch_op_count.py [path] [block_frames ...]

``path`` is one of headline, mastering, sampler, play_file, granular,
synth (default granular); the block sizes default to 4096 8192 16384.  For each
size the script renders one block, then counts the operations PyTorch
dispatches while it renders the next one (views excluded: they launch
nothing), and prints one JSON line; then the growth per extra 2048 frames
between the first two sizes, which for the granular path is the cost of
one allocation chunk, and the count extrapolated to 131072 frames.  A CPU
count: on the card each such operation is about one launch, but the
scalar wrappers (``scalar_tensor``) launch nothing there.
"""

import json
import sys
from pathlib import Path

from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from phonic_tpu_torch.granular1k import granular_program  # noqa: E402
from phonic_tpu_torch.headline import mixer_graph_program  # noqa: E402
from phonic_tpu_torch.mastering import mastering_program  # noqa: E402
from phonic_tpu_torch.play_file import play_file_program  # noqa: E402
from phonic_tpu_torch.sampler64 import sampler_program  # noqa: E402
from phonic_tpu_torch.synth64 import synth_program  # noqa: E402

PROGRAMS = {"headline": mixer_graph_program, "mastering": mastering_program,
            "sampler": sampler_program, "play_file": play_file_program,
            "granular": granular_program, "synth": synth_program}
VIEWS = {"view", "_unsafe_view", "expand", "slice", "select", "unsqueeze",
         "squeeze", "transpose", "permute", "alias", "t", "unbind", "split",
         "as_strided", "reshape", "detach", "lift_fresh"}


class Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.by_name = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name not in VIEWS:
            self.by_name[name] = self.by_name.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


def main():
    args = sys.argv[1:]
    path = args.pop(0) if args and not args[0].isdigit() else "granular"
    sizes = [int(a) for a in args] or [4096, 8192, 16384]
    counts = []
    for n in sizes:
        prog = PROGRAMS[path](block_frames=n, device="cpu")
        state, _ = prog.step(prog.init_state(), prog.block_inputs(0))
        inputs = prog.block_inputs(1)
        with Count() as c:
            prog.step(state, inputs)
        total = sum(c.by_name.values())
        counts.append(total)
        print(json.dumps({"path": path, "block_frames": n, "operations": total,
                          "scalar_wrappers": c.by_name.get("scalar_tensor", 0)}),
              flush=True)
    if len(sizes) >= 2:
        per = (counts[1] - counts[0]) / ((sizes[1] - sizes[0]) / 2048)
        base = counts[0] - per * sizes[0] / 2048
        print(json.dumps({"per_2048_frames": per, "fixed": base,
                          "at_131072": base + per * 64}))


if __name__ == "__main__":
    main()
