"""The port's effects against the JAX package, one effect at a time.

Each effect runs two lanes (the port's leading lane dimension; the JAX
package runs each lane on its own) over two 4096-frame blocks with its state
carried across, with per-sample parameter ramps.  Outputs must agree to
within -90 dB of their peak.  The inputs are seeded mixtures of tones in the
80..2000 Hz band, like the headline graph's sources: the chorus reads its
delay line at LFO-modulated positions, and the two packages' cumulative sums
of the LFO increments round differently (~5e-7 in phase), so its error is
that position error times the input's slope per sample, which white noise
would make the largest possible.

The delay-line reads that replace the JAX package's one-hot matmul window
read (ops/chrono.py) and the reverb's 15-way shift-select must match it
exactly: both pick the same float32 values.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from phonic_tpu.effects import chorus as jchorus, eq5 as jeq5, gain as jgain
from phonic_tpu.effects import reverb as jreverb
from phonic_tpu.graph.nodes import BuildCtx as JCtx
from phonic_tpu.ops import chrono as jchrono
from phonic_tpu_torch.effects import chorus, eq5, gain, reverb
from phonic_tpu_torch.graph.engine import stack_states
from phonic_tpu_torch.graph.nodes import BuildCtx
from phonic_tpu_torch.ops import chrono

SR = 48000
N = 4096
LANES = 2
DB90 = 10.0 ** (-90.0 / 20.0)
JCTX = JCtx(SR, 2, N, 16, jnp.float32)
PCTX = BuildCtx(SR, 2, N, 16, torch.float32, torch.device("cpu"))


def _ramp(v0, v1):
    return np.linspace(v0, v1, N, dtype=np.float32)


def _run(jlanes, plines, params_of, resets=None, band=(80.0, 2000.0)):
    """Render LANES lanes x 2 blocks through both packages and compare.
    ``params_of(block, lane)`` -> {parameter id: float32 [N]}; ``resets``
    names the (block, lane) pairs that get a reverb Reset message; the
    input tones are drawn from the frequency ``band`` (Hz)."""
    jstep = jax.jit(lambda st, x, p: jlanes[0].process(st, x, p, JCTX))
    jstates = [e.init_state(JCTX) for e in jlanes]
    pstate = stack_states([e.init_state(PCTX) for e in plines])
    rng = np.random.default_rng(len(jlanes[0].PARAMS))
    t = np.arange(2 * N) / SR
    freqs = rng.uniform(*band, (LANES, 2, 3, 1))
    phases = rng.uniform(0.0, 2.0 * np.pi, (LANES, 2, 3, 1))
    tones = (0.3 * np.sin(2 * np.pi * freqs * t + phases).sum(axis=2)
             + 0.05).astype(np.float32)  # with a DC offset for the DC filter
    for block in range(2):
        x = tones[..., block * N:(block + 1) * N]
        ps = [params_of(block, lane) for lane in range(LANES)]
        if resets is not None:
            for lane in range(LANES):
                ps[lane]["_reset"] = np.float32((block, lane) in resets)
        want = []
        for lane in range(LANES):
            jstates[lane], y = jstep(
                jstates[lane], jnp.asarray(x[lane]),
                {k: jnp.asarray(v) for k, v in ps[lane].items()})
            want.append(np.asarray(y))
        pvals = {k: torch.as_tensor(np.stack([p[k] for p in ps]))
                 for k in ps[0] if not k.startswith("_")}
        pvals.update({k: np.stack([p[k] for p in ps])
                      for k in ps[0] if k.startswith("_")})
        pstate, got = plines[0].process(pstate, torch.as_tensor(x), pvals,
                                        PCTX)
        got = got.numpy()
        for lane in range(LANES):
            peak = np.abs(want[lane]).max()
            err = np.abs(got[lane] - want[lane]).max()
            assert err <= DB90 * peak, (block, lane, err, peak)


@pytest.mark.parametrize("dc_modes", [(0, 0), (0, 2), (3, 1)])
def test_gain(dc_modes):
    def params(block, lane):
        return {"GAIN": _ramp(0.5 + lane, 0.9 + 0.1 * block),
                "DCFL": np.full(N, dc_modes[lane], np.float32)}
    _run([jgain.GainEffect() for _ in range(LANES)],
         [gain.GainEffect() for _ in range(LANES)],
         params)


def test_eq5():
    def params(block, lane):
        p = {}
        for i, f in enumerate((100.0, 1000.0, 4000.0, 8000.0, 12000.0)):
            p[f"gan{i+1}"] = _ramp(-6.0 + 2 * i + lane, 4.0 - i + block)
            p[f"frq{i+1}"] = _ramp(f * (1 + 0.1 * lane), f * (1.2 - 0.1 * block))
            p[f"bw_{i+1}"] = np.full(N, 0.5 + 0.2 * i + 0.1 * lane, np.float32)
        return p
    _run([jeq5.Eq5Effect() for _ in range(LANES)],
         [eq5.Eq5Effect() for _ in range(LANES)], params)


def test_chorus():
    def params(block, lane):
        return {
            "rate": _ramp(0.5 + lane, 1.5), "phas": np.full(N, 1.0 + lane, np.float32),
            "dpth": _ramp(0.25, 0.4), "fdbk": _ramp(0.5, 0.3 - 0.5 * lane),
            "dlay": _ramp(12.0, 14.0 + block), "wet_": np.full(N, 0.5, np.float32),
            "fltt": np.full(N, lane, np.float32),
            "fltf": _ramp(8000.0, 6000.0), "fltq": np.full(N, 0.3, np.float32),
        }
    _run([jchorus.ChorusEffect() for _ in range(LANES)],
         [chorus.ChorusEffect() for _ in range(LANES)], params)


@pytest.mark.parametrize("resets", [None, {(1, 1)}])
def test_reverb(resets):
    """Both lanes with their own vibrato seeds; optionally a Reset (flush
    every delay line and filter state) on lane 1 at the second block."""
    def params(block, lane):
        return {"room": _ramp(0.6 + 0.05 * lane + 0.05 * block, 0.65 + 0.05 * block),
                "wet ": _ramp(0.2, 0.3 + 0.1 * lane)}
    seeds = (0xA1B2, 7)
    _run([jreverb.ReverbEffect(room_size=0.6, wet=0.2, min_room_size=0.55,
                               seed=s) for s in seeds],
         [reverb.ReverbEffect(room_size=0.6, wet=0.2, min_room_size=0.55,
                              seed=s) for s in seeds], params, resets)


@pytest.mark.parametrize("per_channel", [False, True])
def test_window_read_is_exact(per_channel):
    """ops/chrono.read_frac_win: the port's gather returns exactly the
    values of the JAX package's one-hot matmul read."""
    rng = np.random.default_rng(21)
    w, b = chrono.hist_len(5362), 512
    win = rng.normal(size=(2, w)).astype(np.float32)
    shape = (2, b) if per_channel else (b,)
    offs = rng.uniform(b + 1, w - 2, shape).astype(np.float32)
    offs.flat[::7] = np.round(offs.flat[::7])  # integer offsets too
    want = np.asarray(jchrono.read_frac_win(jnp.asarray(win), jnp.asarray(offs)))
    got = chrono.read_frac_win(torch.as_tensor(win), torch.as_tensor(offs))
    assert np.array_equal(got.numpy(), want)


def test_reverb_vibrato_read_is_exact():
    """The reverb FDN's fractional vibrato read: the JAX package's 15-way
    shift-select over per-line windows (effects/reverb.py:325-339) and the
    port's single gather pick identical values."""
    rng = np.random.default_rng(22)
    h, b = 8192, 2048
    buf = rng.normal(size=(8, 2, h)).astype(np.float32)
    delay = (np.array([79, 73, 71, 67, 61, 59, 53, 47]) * 52.0).astype(np.int32)
    k_int = rng.integers(0, 15, size=(8, 2, b)).astype(np.int32)

    jbuf, jk = jnp.asarray(buf), jnp.asarray(k_int)
    wins = jnp.concatenate([
        jax.lax.dynamic_slice(jbuf, (l, 0, h - int(delay[l])), (1, 2, b + 16))
        for l in range(8)])
    v1 = jnp.zeros((8, 2, b), jnp.float32)
    v2 = jnp.zeros((8, 2, b), jnp.float32)
    for k in range(15):
        sel = jk == k
        v1 = jnp.where(sel, jax.lax.dynamic_slice_in_dim(wins, k, b, axis=-1), v1)
        v2 = jnp.where(sel, jax.lax.dynamic_slice_in_dim(wins, k + 1, b, axis=-1), v2)

    idx = (torch.as_tensor(h - delay.astype(np.int64))[:, None, None]
           + torch.arange(b) + torch.as_tensor(k_int).long())
    tbuf = torch.as_tensor(buf)
    assert np.array_equal(torch.gather(tbuf, -1, idx).numpy(), np.asarray(v1))
    assert np.array_equal(torch.gather(tbuf, -1, idx + 1).numpy(),
                          np.asarray(v2))


def test_reverb_vibrato_phases_match():
    """Both packages seed the vibrato phases from the same numpy draw."""
    for seed in (0xA1B2, 5):
        want = np.asarray(jreverb.ReverbEffect(seed=seed).init_state(JCTX)["vib_phase"])
        got = reverb.ReverbEffect(seed=seed).init_state(PCTX)["vib_phase"]
        assert np.array_equal(got.numpy(), want)
