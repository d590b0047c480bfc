"""The port's 64-voice sampler (BASELINE config 2) against the JAX package
at bench.py's 131072-frame blocks, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_sampler_parity.py [blocks]

Renders ``blocks`` blocks (default 4) of bench.py's ``config_sampler_64``
through the JAX package and of ``sampler_program`` through the port, both
on the CPU, and prints each block's peak, largest difference and their
ratio in dB (null for a block that is silent in the JAX render).  A
measurement, not a test: the tests compare at 4096-frame
blocks (tests/test_torch_sampler.py).
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import phonic_tpu as jp  # noqa: E402
from phonic_tpu_torch.sampler64 import sampler_program  # noqa: E402

BLOCK = 131072


def main():
    jax.config.update("jax_platforms", "cpu")
    blocks = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    jprog = jp.RenderProgram(bench.config_sampler_64().root,
                             jp.EngineConfig(sample_rate=48000,
                                             block_frames=BLOCK))
    want = np.asarray(jprog.render(blocks * BLOCK, mode="loop"))
    got = sampler_program(block_frames=BLOCK, device="cpu").render(blocks * BLOCK)
    rows = []
    for b in range(blocks):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        peak = float(np.abs(want[:, sl]).max())
        err = float(np.abs(got[:, sl] - want[:, sl]).max())
        db = 20 * np.log10(max(err, 1e-30) / peak) if peak > 0 else None
        rows.append({"block": b, "peak": peak, "max_abs_err": err, "db": db})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"blocks": blocks, "block_frames": BLOCK, "worst_db": max(
        (r["db"] for r in rows if r["db"] is not None), default=None)}))


if __name__ == "__main__":
    main()
