"""The port's synth path (``synth_64v``) against the JAX package at
131072-frame blocks, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_synth_parity.py [blocks] [--attribute]

Builds the graph of ``phonic_tpu_torch.synth64.synth_graph`` from the JAX
package (the same notes, bank frequencies, effects and node names), renders
``blocks`` blocks (default 2) through both packages on the CPU, and prints
each block's peak, largest difference and their ratio in dB.  A
measurement, not a test: the tests compare at 2048-4096-frame blocks and
dyadic phase increments (tests/test_torch_synth.py).

``--attribute`` tests the cause of the gap: in this process only, the JAX
package's oscillator phases are summed in float64 and its ``jnp.exp2`` is
evaluated in float64 (both rounded once to float32, as the port does),
and the port's frequency multiplier divides by ``exp2`` of JAX's float32
argument ``(note - 60) * f32(1/12)``; no file of either package changes.
If the gap then closes, JAX's float32 phase sums and ``exp2`` and the
multiplier's argument are its whole cause.
"""

import json
import sys
from pathlib import Path

import jax
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import phonic_tpu as jp  # noqa: E402
from phonic_tpu import synths as jsynths  # noqa: E402
from phonic_tpu.effects.filter import FilterEffect  # noqa: E402
from phonic_tpu.effects.pan import PanningEffect  # noqa: E402
from phonic_tpu_torch import synth64  # noqa: E402

BLOCK = 131072


def jax_graph():
    """synth64.synth_graph, built from the JAX package."""
    main = jp.Mixer("main")
    gen = jp.SynthGenerator(jsynths.sub3(), jp.GeneratorPlaybackOptions(
        voices=synth64.VOICES), release_secs=0.3, name="synth")
    for t, note, vel in synth64.notes():
        gen.note_off(gen.note_on(note, vel, time=t), time=t + synth64.HOLD)
    main.add_source(gen)
    bank = main.add_mixer(jp.Mixer("bank"))
    dx7 = jsynths.dx7()
    for k, o in enumerate(synth64.bank_options()):
        bank.add_source(jp.SynthSource(dx7, jp.SynthPlaybackOptions(
            frequency=o.frequency, start_time=o.start_time,
            duration=o.duration, volume=o.volume), name=f"tone{k}"))
    bank.add_effect(FilterEffect("Lowpass", 4000.0, 0.707, name="filter"))
    main.add_effect(PanningEffect(pan=0.2, width=1.2, name="pan"))
    return main


def attribute():
    """The substitutions of ``--attribute`` (see the module docstring)."""
    import jax.numpy as jnp
    import torch

    import phonic_tpu.ops.osc as josc
    import phonic_tpu_torch.generators.synth as psynth
    from phonic_tpu_torch.ops.precision import recip32

    jax.config.update("jax_enable_x64", True)
    exp2_32 = jnp.exp2

    def exp2(x):
        x = jnp.asarray(x)
        return exp2_32(x.astype(jnp.float64)).astype(x.dtype)

    def phase_accumulate(phase0, freq, sr):
        inc = (jnp.asarray(freq, jnp.float32) * np.float32(recip32(sr))
               ).astype(jnp.float64)
        csum = jnp.cumsum(inc)
        p0 = jnp.asarray(phase0, jnp.float64)

        def wrap(v):
            f = (v - jnp.floor(v)).astype(jnp.float32)
            return jnp.where(f >= 1.0, f - 1.0, f)
        return wrap(p0 + (csum - inc)), wrap(p0 + csum[-1])

    jnp.exp2 = exp2
    josc.phase_accumulate = phase_accumulate
    psynth.note_speed = lambda note: torch.exp2(
        ((note - 60.0) * recip32(12.0)).double()).float()


def main():
    jax.config.update("jax_platforms", "cpu")
    args = [a for a in sys.argv[1:] if a != "--attribute"]
    if "--attribute" in sys.argv:
        attribute()
    blocks = int(args[0]) if args else 2
    jprog = jp.RenderProgram(jax_graph(), jp.EngineConfig(
        sample_rate=48000, block_frames=BLOCK))
    want = np.asarray(jprog.render(blocks * BLOCK, mode="loop"))
    got = synth64.synth_program(block_frames=BLOCK, device="cpu").render(
        blocks * BLOCK)
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
