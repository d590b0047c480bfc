"""Where the port's play_grains example parts from the JAX example, on the
CPU.

    JAX_PLATFORMS=cpu python scripts/torch_grains_attribution.py

1. XLA's float32 contraction: the JAX package's ``ops/lfo.sine_approx``
   compiled by XLA's CPU backend against numpy emulations of it, each
   multiply-add rounded once (fused) or twice, and against the port's
   ``sine_approx``; prints the mismatches of each over 200,001 inputs.
2. The renders: the port's ``phonic_tpu_torch.examples.play_grains``
   against the JAX example run with float64 phase sums (the first part of
   ``tests/test_torch_examples.ATTRIBUTED``), and with the modulation
   matrix's sine and sum of products also evaluated by numpy (all of it);
   prints the largest difference in dB of peak, per 8192-frame block.
3. With the first attribution only: every grain pool's slots after each
   2048-frame allocation chunk, voice by voice (matched by seed), and the
   per-sample granular parameters fed to each chunk; prints which fields
   differ, how often and by how much.

A measurement, not a test: ``test_example_matches_attributed_jax`` holds
the samples to -90 dB.
"""

import os
import pickle
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import test_torch_examples as T  # noqa: E402
import phonic_tpu_torch.generators.sampler as psampler  # noqa: E402
from phonic_tpu_torch.io.wav import read_wav  # noqa: E402
from phonic_tpu_torch.ops import lfo as plfo  # noqa: E402

SLOTS = ("g_trig", "g_dur", "g_pos0", "g_inc", "g_winc", "g_vol", "g_pan")
PARAMS = ("size_ms", "density", "variation", "spray", "pan_spread",
          "position", "pos_mod", "step", "speed_mod", "speed", "vol", "pan")
SINE_ONLY = T.ATTRIBUTED.split("# The modulation matrix's LFO sine")[0] + \
    "\nsys.argv = sys.argv[1:]\nrunpy.run_path(sys.argv[0], run_name='__main__')\n"

# appended to the JAX run of step 3: record each chunk's slots and inputs
RECORD = """
import pickle, atexit
import phonic_tpu.generators.granular as jg
REC = []
_alloc = jg.granular_voice_alloc


def _rec(f0, seed, *vals):
    REC.append((int(f0), int(seed)) + tuple(np.asarray(v).copy() for v in vals))


def granular_voice_alloc(state, **kw):
    new, fidx, g = _alloc(state, **kw)
    jax.debug.callback(_rec, kw["frame0"], kw["seed"],
                       *[new[k] for k in %r], *[kw[k] for k in %r])
    return new, fidx, g


jg.granular_voice_alloc = granular_voice_alloc
atexit.register(lambda: pickle.dump(REC, open(%r, "wb")))
"""


def sine_contraction():
    import jax
    import jax.numpy as jnp  # noqa: F401
    from phonic_tpu.ops import lfo as jlfo
    x = np.linspace(-np.pi, np.pi, 200001).astype(np.float32)
    xla = np.asarray(jax.jit(jlfo.sine_approx)(x))
    port = plfo.sine_approx(torch.as_tensor(x)).numpy()
    f32, f64 = np.float32, np.float64
    b, c, p = f32(4 / np.pi), f32(-4 / np.pi ** 2), f32(0.225)
    cxx = (c * x) * np.abs(x)
    fused_y = (f64(b) * x + cxx).astype(f32)
    fused_t = (f64(fused_y) * np.abs(fused_y) - fused_y).astype(f32)
    fused = (f64(p) * fused_t + fused_y).astype(f32)
    plain_y = b * x + cxx
    plain = p * (plain_y * np.abs(plain_y) - plain_y) + plain_y
    print("1. sine_approx over 200,001 inputs: XLA vs fused emulation "
          f"{int((xla != fused).sum())} mismatches, XLA vs unfused "
          f"{int((xla != plain).sum())}, the port vs unfused "
          f"{int((port != plain).sum())}")


def jax_example(script, out, extra=""):
    code = script.replace("sys.argv = sys.argv[1:]", extra + "\nsys.argv = sys.argv[1:]")
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-c", code,
                    str(ROOT / "examples" / "play_grains.py"), "-o", str(out)],
                   env=env, cwd=ROOT, check=True, stdout=subprocess.DEVNULL)
    return np.asarray(read_wav(out)[0])


def db(a, b):
    return 20 * np.log10(max(float(np.abs(a - b).max()), 1e-30)
                         / float(np.abs(b).max()))


def main():
    sine_contraction()
    tmp = Path(tempfile.mkdtemp())
    rec = []
    alloc = psampler.granular_voice_alloc

    def recording(state, **kw):  # the port's chunks, as step 3 compares
        new, fidx, g = alloc(state, **kw)
        v = kw["held"].shape[0]
        rec.append((int(kw["frame0"]), kw["seed"].cpu().numpy().copy())
                   + tuple(new[k].cpu().numpy().copy() for k in SLOTS)
                   + tuple(torch.as_tensor(kw[k]).expand(v, kw["n"]).cpu()
                           .numpy().copy() for k in PARAMS))
        return new, fidx, g

    psampler.granular_voice_alloc = recording
    port = np.asarray(read_wav(T.port_example("play_grains", tmp / "port.wav"))[0])
    psampler.granular_voice_alloc = alloc
    jrec = tmp / "jax.pkl"
    first = jax_example(SINE_ONLY, tmp / "sums.wav",
                        RECORD % (SLOTS, PARAMS, str(jrec)))
    full = jax_example(T.ATTRIBUTED, tmp / "full.wav")
    for name, want in (("float64 sums", first), ("and the matrix", full)):
        n = want.shape[1] // 8192 * 8192
        d = np.abs(port - want).max(0)[:n].reshape(-1, 8192).max(1)
        blocks = 20 * np.log10(np.maximum(d, 1e-30) / np.abs(want).max())
        print(f"2. port vs JAX ({name}): {db(port, want):.1f} dB; per block "
              f"{np.round(blocks, 1).tolist()}")
    jr = pickle.load(open(jrec, "rb"))
    nv = len(rec[0][1])
    diffs = {}
    for c, chunk in enumerate(rec):
        by_seed = {j[1]: j for j in jr[c * nv:(c + 1) * nv]}
        lanes = [by_seed[int(s)] for s in chunk[1]]
        for i, name in enumerate(SLOTS + PARAMS):
            want = np.stack([np.broadcast_to(j[i + 2], chunk[i + 2].shape[1:])
                             for j in lanes])
            d = np.abs(want.astype(np.float64) - chunk[i + 2])
            if d.max() > 0:
                n_chunks, worst = diffs.get(name, (0, 0.0))
                diffs[name] = (n_chunks + 1, max(worst, float(d.max())))
    print(f"3. {len(rec)} chunks x {nv} voices; fields that differ "
          f"(chunks, largest difference): {diffs or 'none'}")


if __name__ == "__main__":
    main()
