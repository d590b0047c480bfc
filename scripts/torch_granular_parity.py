"""The port's granular sampler (BASELINE config 4, granular_1k) against the
JAX package at bench.py's 131072-frame blocks, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_granular_parity.py [blocks] [--dyadic]

Renders ``blocks`` blocks (default 2) of bench.py's ``config_granular_1k``
through the JAX package and of ``granular_program`` through the port, both
on the CPU, and prints each block's peak, largest difference and their
ratio in dB.  ``--dyadic`` sets the grain density to 93.75 Hz in both
packages (a trigger step of 2**-9 per sample at 48 kHz, which sums exactly
in float32): at bench.py's 100 Hz the packages' trigger-phase sums round
differently (JAX sums in float32, the port in float64), so a grain can
start one sample apart.  A measurement, not a test: the tests compare at
small sizes (tests/test_torch_granular.py).  The port's CPU render of a
block holds a few GB of [1000, 131072] tensors.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402
import phonic_tpu as jp  # noqa: E402
from phonic_tpu_torch.config import EngineConfig  # noqa: E402
from phonic_tpu_torch.graph.engine import RenderProgram  # noqa: E402
from phonic_tpu_torch.granular1k import granular_graph  # noqa: E402

BLOCK = 131072


def main():
    jax.config.update("jax_platforms", "cpu")
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    dyadic = "--dyadic" in sys.argv[1:]
    blocks = int(args[0]) if args else 2
    jroot, root = bench.config_granular_1k().root, granular_graph()
    if dyadic:
        for r in (jroot, root):
            r.sources[0].granular.density_hz = 93.75
    prog = RenderProgram(root, EngineConfig(sample_rate=48000,
                                            block_frames=BLOCK), device="cpu")
    jprog = jp.RenderProgram(jroot, jp.EngineConfig(sample_rate=48000,
                                                    block_frames=BLOCK))
    jstate, state = jprog.init_state(), prog.init_state()
    rows = []
    for b in range(blocks):
        jstate, want = jprog.step_packed(jstate, jprog.packed_block_inputs(b))
        state, got = prog.step(state, prog.block_inputs(b))
        want, got = np.asarray(want), got.numpy()
        peak = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        db = 20 * np.log10(max(err, 1e-30) / peak) if peak > 0 else None
        rows.append({"block": b, "peak": peak, "max_abs_err": err, "db": db})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"blocks": blocks, "block_frames": BLOCK,
                      "density_hz": 93.75 if dyadic else 100.0,
                      "worst_db": max((r["db"] for r in rows
                                       if r["db"] is not None), default=None)}))


if __name__ == "__main__":
    main()
