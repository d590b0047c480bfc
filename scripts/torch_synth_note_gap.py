"""Where the port's synth generator parts from the JAX package's, note by
note, on the CPU.

    JAX_PLATFORMS=cpu python scripts/torch_synth_note_gap.py

The scenario of ``tests/test_torch_graph_sharded.py``'s note-pair test: a
65536 Hz engine, 1024-frame blocks, sub3 without detune, two voices; the
first note at frame 0, the second at 1024, the first released at 2048.

1. The renders: the port against the JAX package, and against the JAX
   package with its oscillator phase sums evaluated by numpy in float64
   and rounded once (the test's ``phase_accumulate`` through
   ``jax.pure_callback``, as the port sums them); prints the largest
   difference in dB of peak.
2. Stage by stage, voice by voice, for each pair: the port's stages
   (recorded from its render) and the JAX package's functions run on the
   same per-sample inputs, each against a float64 oracle of the same
   synth (phases, ``morph_osc``, ``mix / 3``, the SVF's coefficients and
   its recurrence): the error each side carries at each stage
   (``chain``), and each stage's own error on the oracle's inputs rounded
   to float32 (``alone``).  The per-sample inputs (each voice's frequency,
   and the cutoff the AHDSR sweeps) come from the port's render: the note
   logic and the envelope do not part the packages, as part 1 shows.

A measurement, not a test: ``test_synth_note_pairs_match_attributed_jax``
holds the three pairs to -90 dB of the attributed render.
"""

import math
import os
import sys
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import phonic_tpu as jp  # noqa: E402
import phonic_tpu.ops.osc as josc  # noqa: E402
import phonic_tpu_torch as pt  # noqa: E402
import phonic_tpu_torch.synths as psyn  # noqa: E402
from phonic_tpu.ops import filters as jfil  # noqa: E402
from phonic_tpu_torch.ops import filters as pfil  # noqa: E402
from phonic_tpu_torch.ops import osc as posc  # noqa: E402
from test_torch_graph_sharded import (  # noqa: E402
    PAIRS, _attributed_phase_accumulate as attributed_phase_accumulate,
    _synth_pair as graph)

SR = 65536
BLOCK = 1024
SHAPE, CUTOFF, RESO = 2.0, 2500.0, 0.4  # sub3's defaults
F32, F64 = np.float32, np.float64


def db(err, peak):
    return 20.0 * math.log10(max(float(err), 1e-30) / float(peak))


def renders():
    print("1. renders: port vs JAX, and vs JAX with numpy float64 phase sums")
    plain = josc.phase_accumulate
    for first, second in PAIRS:
        pprog = pt.RenderProgram(graph(pt, first, second), pt.EngineConfig(
            sample_rate=SR, block_frames=BLOCK, device="cpu"))
        got = pprog.render(3 * BLOCK)
        row = []
        for fn in (plain, attributed_phase_accumulate):
            josc.phase_accumulate = fn
            jprog = jp.RenderProgram(graph(jp, first, second), jp.EngineConfig(
                sample_rate=SR, block_frames=BLOCK))
            want = jprog.render(3 * BLOCK, mode="loop")
            row.append(db(np.abs(got - want).max(), np.abs(want).max()))
        josc.phase_accumulate = plain
        print(f"   {first} -> {second}: {row[0]:.1f} dB, attributed "
              f"{row[1]:.1f} dB")


def record_port(first, second):
    """The port's render with every stage's inputs and outputs recorded
    per block ([2 voices, n] each)."""
    rec: dict = {}

    def keep(name, x):
        rec.setdefault(name, []).append(x.detach().clone().numpy())

    saved = (posc.phase_accumulate, posc.morph_osc, pfil.tpt_process,
             pfil.svf_coefficients, psyn._env)

    def phase(p0, f, sr):
        ph, end = saved[0](p0, f, sr)
        keep("p0", torch.as_tensor(p0))
        keep("freq", f)
        keep("phase", ph)
        return ph, end

    def morph(ph, s, f, sr):
        y = saved[1](ph, s, f, sr)
        keep("osc", y)
        return y

    def tpt(st, x, c, **kw):
        keep("mix", x)
        keep("ic1", st.ic1)
        keep("ic2", st.ic2)
        s, y = saved[2](st, x, c, **kw)
        keep("svf", y)
        return s, y

    def svf(kind, sr, cut, res):
        keep("cut", cut)
        c = saved[3](kind, sr, cut, res)
        for i in range(3):
            keep(f"a{i + 1}", c[i])
        return c

    def env(ctx, *a):
        y = saved[4](ctx, *a)
        keep("env", y)
        return y

    (posc.phase_accumulate, posc.morph_osc, pfil.tpt_process,
     pfil.svf_coefficients, psyn._env) = phase, morph, tpt, svf, env
    try:
        prog = pt.RenderProgram(graph(pt, first, second), pt.EngineConfig(
            sample_rate=SR, block_frames=BLOCK, device="cpu"))
        prog.render(3 * BLOCK)
    finally:
        (posc.phase_accumulate, posc.morph_osc, pfil.tpt_process,
         pfil.svf_coefficients, psyn._env) = saved
    # three oscillators per block (equal without detune): keep the first
    for k in ("p0", "freq", "phase", "osc"):
        rec[k] = rec[k][::3]
    return rec


# -- the float64 oracle of sub3 (phonic_tpu/synths/__init__.py:69-95) --

def o_phase(p0, freq):
    inc = np.asarray(freq, F32).astype(F64) / SR
    raw = np.asarray(p0, F64)[..., None] + np.cumsum(inc, -1) - inc
    return raw - np.floor(raw)


def o_blep(t, dt):
    a = t / dt
    b = (t - 1.0) / dt + 1.0
    return np.where(t < dt, 2 * a - a * a - 1,
                    np.where(t > 1 - dt, b * b + 2 * b + 1, 0.0))


def o_morph(ph, freq):
    dt = np.asarray(freq, F64) / SR
    waves = [np.sin(2 * np.pi * ph),
             np.where(ph < .25, 4 * ph, np.where(ph < .75, 2 - 4 * ph,
                                                 4 * ph - 4)),
             2 * ph - 1 - o_blep(ph, dt),
             np.where(ph < .5, 1.0, -1.0) + o_blep(ph, dt)
             - o_blep(np.mod(ph - .5, 1.0), dt)]
    lo = min(int(SHAPE), 2)
    frac = SHAPE - lo
    return waves[lo] * (1 - frac) + waves[lo + 1] * frac


def o_coefs(cut):
    g = np.tan(np.pi * np.asarray(cut, F64) / SR)
    k = max(2.0 * (1.0 - RESO * 0.97), 0.03)
    a1 = 1.0 / (1.0 + g * (g + k))
    return a1, g * a1, g * g * a1


def o_svf(ic1, ic2, x, a1, a2, a3):
    """The TPT lowpass (its state recurrence and midpoint taps) in
    float64, one voice row at a time."""
    x = np.asarray(x, F64)
    y = np.empty_like(x)
    s1, s2 = np.asarray(ic1, F64).copy(), np.asarray(ic2, F64).copy()
    for t in range(x.shape[-1]):
        n1 = (2 * a1[:, t] - 1) * s1 - 2 * a2[:, t] * s2 + 2 * a2[:, t] * x[:, t]
        n2 = 2 * a2[:, t] * s1 + (1 - 2 * a3[:, t]) * s2 + 2 * a3[:, t] * x[:, t]
        y[:, t] = 0.5 * (n2 + s2)
        s1, s2 = n1, n2
    return y


def jax_stages(first_rec):
    """The JAX package's stage functions, jitted, over the recorded
    per-sample inputs of each block; phases and the SVF state carried in
    float32 from block to block as its step carries them."""
    def voice_block(p0, freq, env, ic1, ic2, cut):
        ph, end = josc.phase_accumulate(p0, freq, SR)
        y = josc.morph_osc(ph, jnp.float32(SHAPE), freq, SR)
        mix = (y + y + y) / 3.0
        c = jfil.svf_coefficients(jfil.LOWPASS, SR, cut, RESO)
        st, f = jfil.tpt_process(jfil.TptState(ic1[None], ic2[None]),
                                 mix[None], c)
        return end, ph, y, mix, c[:3], st, f[0]
    run = jax.jit(jax.vmap(voice_block))
    out: dict = {}
    p0 = first_rec["p0"][0].astype(F32)
    ic1 = np.zeros(2, F32)
    ic2 = np.zeros(2, F32)
    for b in range(len(first_rec["freq"])):
        end, ph, y, mix, c, st, f = run(
            p0, first_rec["freq"][b], first_rec["env"][b], ic1, ic2,
            first_rec["cut"][b])
        for k, v in (("phase", ph), ("osc", y), ("mix", mix), ("a1", c[0]),
                     ("a2", c[1]), ("a3", c[2]), ("svf", f)):
            out.setdefault(k, []).append(np.asarray(v))
        p0 = np.asarray(end, F32)
        ic1, ic2 = (np.asarray(s[:, 0], F32) for s in st)
    return out


def stages(first, second):
    rec = record_port(first, second)
    jx = jax_stages(rec)
    blocks = len(rec["freq"])
    # the oracle's chain, block by block, from the same recorded inputs
    orc: dict = {}
    p0 = np.zeros(2)
    ic1 = ic2 = np.zeros(2)
    for b in range(blocks):
        ph = o_phase(p0, rec["freq"][b])
        inc = rec["freq"][b].astype(F32).astype(F64) / SR
        p0 = np.mod(p0 + inc.sum(-1), 1.0)
        osc = o_morph(ph, rec["freq"][b])
        mix = osc
        a1, a2, a3 = o_coefs(rec["cut"][b])
        y = o_svf(ic1, ic2, mix, a1, a2, a3)
        # the state after the block, from the float64 recurrence
        s1, s2 = np.asarray(ic1, F64), np.asarray(ic2, F64)
        for t in range(BLOCK):
            s1, s2 = ((2 * a1[:, t] - 1) * s1 - 2 * a2[:, t] * s2
                      + 2 * a2[:, t] * mix[:, t],
                      2 * a2[:, t] * s1 + (1 - 2 * a3[:, t]) * s2
                      + 2 * a3[:, t] * mix[:, t])
        ic1, ic2 = s1, s2
        for k, v in (("phase", ph), ("osc", osc), ("mix", mix), ("a1", a1),
                     ("a2", a2), ("a3", a3), ("svf", y)):
            orc.setdefault(k, []).append(v)
    # each stage alone, on the oracle's inputs rounded to float32
    alone = {"port": {}, "jax": {}}
    jm = jax.jit(lambda ph, f: josc.morph_osc(ph, jnp.float32(SHAPE), f, SR))
    jmix = jax.jit(lambda y: (y + y + y) / 3.0)
    jc = jax.jit(lambda cut: jfil.svf_coefficients(jfil.LOWPASS, SR, cut,
                                                   RESO)[:3])
    jsvf = jax.jit(jax.vmap(lambda x, a1, a2, a3: jfil.tpt_process(
        jfil.TptState(jnp.zeros(1, jnp.float32), jnp.zeros(1, jnp.float32)),
        x[None], jfil.TptCoefficients(a1, a2, a3, 0.0, 0.0, 1.0))[1][0]))
    for b in range(blocks):
        ph32 = orc["phase"][b].astype(F32)
        f32 = rec["freq"][b].astype(F32)
        o32 = orc["osc"][b].astype(F32)
        c32 = [orc[f"a{i}"][b].astype(F32) for i in (1, 2, 3)]
        cut = torch.as_tensor(rec["cut"][b])
        pc = psyn.filters.svf_coefficients(psyn.filters.LOWPASS, SR, cut,
                                           torch.tensor(RESO))
        ps = pfil.tpt_process(
            pfil.TptState(torch.zeros(2), torch.zeros(2)),
            torch.as_tensor(o32), pfil.TptCoefficients(
                *(torch.as_tensor(c) for c in c32), 0.0, 0.0, 1.0))[1]
        pairs = {
            "osc": (posc.morph_osc(torch.as_tensor(ph32), SHAPE,
                                   torch.as_tensor(f32), SR).numpy(),
                    np.asarray(jm(ph32, f32)), orc["osc"][b]),
            "mix": ((torch.as_tensor(o32 + o32 + o32)
                     * psyn.recip32(3.0)).numpy(),
                    np.asarray(jmix(o32)), orc["mix"][b]),
            "svf coefficients": (np.stack([c.numpy() for c in pc[:3]]),
                                 np.stack([np.asarray(c) for c in jc(
                                     rec["cut"][b])]),
                                 np.stack([orc[f"a{i}"][b] for i in (1, 2, 3)])),
        }
        if b == 0:  # the recurrence from rest, on block 0's inputs
            pairs["svf scan"] = (ps.numpy(), np.asarray(jsvf(o32, *c32)),
                                 o_svf(np.zeros(2), np.zeros(2), o32,
                                       *(c.astype(F64) for c in c32)))
        for k, (p, j, o) in pairs.items():
            for side, v in (("port", p), ("jax", j)):
                e = np.abs(np.asarray(v, F64) - o)
                alone[side][k] = max(alone[side].get(k, 0.0), float(e.max()))
    print(f"\n2. {first} -> {second}: stages against the float64 oracle, "
          "max abs error per voice over 3 blocks")
    print("   (voice 0 plays the first note, voice 1 idles at note 60 in "
          "block 0, then plays the second)")
    for k in ("phase", "osc", "mix", "a1", "a2", "a3", "svf"):
        for v in range(2):
            o = np.stack([x[v] for x in orc[k]])
            p = np.stack([x[v] for x in rec[k]]) if k in rec else None
            j = np.stack([x[v] for x in jx[k]]) if k in jx else None
            pe = np.abs(p - o).max()
            je = np.abs(j - o).max()
            near = "port" if pe < je else ("jax" if je < pe else "equal")
            print(f"   chain {k:6s} voice {v}: port {pe:.3e}  jax {je:.3e}"
                  f"  nearer: {near}")
    for k in alone["port"]:
        pe, je = alone["port"][k], alone["jax"][k]
        near = "port" if pe < je else ("jax" if je < pe else "equal")
        print(f"   alone {k:16s}: port {pe:.3e}  jax {je:.3e}  nearer: {near}")
    idle = rec["freq"][0][1, 0]
    inc = F32(idle) * F32(1.0 / SR)
    print(f"   voice 1 idles at {idle:.5f} Hz in block 0: increment "
          f"{inc!r} is {'dyadic' if float(inc) * 2 ** 24 % 1 == 0 else 'not dyadic'}"
          f"; its phase entering block 1: port {rec['p0'][1][1]!r}, "
          f"float64 {np.mod(1024 * float(inc), 1.0)!r}")


def main():
    renders()
    for first, second in PAIRS:
        stages(first, second)


if __name__ == "__main__":
    main()
