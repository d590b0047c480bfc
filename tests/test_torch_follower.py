"""phonic_tpu_torch/ops/follower.py and ops/lfo.py against the JAX package.

The plain versions of kernels 4 and 5 (``follower_plain``, ``gate_plain``;
the CUDA kernels in csrc/follower.cu match them bit for bit on a card,
which chip_smoke.py checks) must match
  * the JAX Pallas kernels ``_follower_call`` / ``_gate_call`` in interpret
    mode on the CPU, and the XLA scans ``_follower_xla`` / ``_gate_xla``,
    to atol 2e-4 dB, the bound tests/test_follower.py holds them to;
  * a per-sample float32 NumPy loop exactly: one rounding per operation,
    no fused multiply-add, which is the arithmetic the kernels reproduce.
A block split in two with the state carried gives the whole block's result
exactly.  The LFO's seven waveforms and its counter hash match the JAX
package exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phonic_tpu.ops import envelope as jenv
from phonic_tpu.ops import follower as jfo
from phonic_tpu.ops import lfo as jlfo
from phonic_tpu_torch.ops import envelope, follower as fo
from phonic_tpu_torch.ops import lfo

ATOL = 2e-4  # dB


def _streams(b, n, seed):
    """As tests/test_follower.py's streams, one row per lane, with the
    attack/release pair varied per lane."""
    r = np.random.default_rng(seed)
    x = r.uniform(-90, 0, (b, n)).astype(np.float32)
    aa = np.repeat(np.float32([0.05, 0.1, 0.02][:b])[:, None], n, 1)
    ra = np.repeat(np.float32([0.002, 0.005, 0.001][:b])[:, None], n, 1)
    return x, aa, ra


def _gate_streams(b, n, seed):
    x, aa, ra = _streams(b, n, seed)
    thr = np.full((b, n), -40.0, np.float32)
    thr[:, n // 2:] = -30.0
    rng = np.full((b, n), -60.0, np.float32)
    hs = np.full((b, n), 441.0, np.float32)
    hs[-1] = 17.0
    return x, aa, ra, thr, rng, hs


def _np_follower(x, aa, ra, env0):
    env = np.float32(env0).copy()
    out = np.empty_like(x)
    for i in range(x.shape[-1]):
        a = np.where(x[:, i] > env, aa[:, i], ra[:, i])
        env = env + a * (x[:, i] - env)
        out[:, i] = env
    return env, out


def _np_gate(x, aa, ra, thr, rng, hs, env0, hold0, gain0):
    env, hold, gain = (np.float32(v).copy() for v in (env0, hold0, gain0))
    out = np.empty_like(x)
    for i in range(x.shape[-1]):
        a = np.where(x[:, i] > env, aa[:, i], ra[:, i])
        env = env + a * (x[:, i] - env)
        is_open = env >= thr[:, i]
        target = np.where(is_open | (hold > 0), np.float32(0.0), rng[:, i])
        hold = np.where(is_open, hs[:, i], np.maximum(hold - np.float32(1.0),
                                                       np.float32(0.0)))
        a2 = np.where(target > gain, aa[:, i], ra[:, i])
        gain = gain + a2 * (target - gain)
        out[:, i] = gain
    return (env, hold, gain), out


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("b,n", [(1, 1000), (3, 1000), (1, 4096), (3, 4096)])
def test_follower_matches_jax(b, n):
    x, aa, ra = _streams(b, n, seed=n + b)
    env0 = np.linspace(-120.0, -10.0, b).astype(np.float32)
    env_end, env = fo.follower_plain(*_t(x, aa, ra, env0))
    env_end, env = env_end.numpy(), env.numpy()

    want_end, want = _np_follower(x, aa, ra, env0)
    assert np.array_equal(env, want) and np.array_equal(env_end, want_end)

    kern = np.asarray(jfo._follower_call(jnp.asarray(x), jnp.asarray(aa),
                                         jnp.asarray(ra), jnp.asarray(env0),
                                         jfo._chunk_for(n)))
    np.testing.assert_allclose(env, kern, atol=ATOL)
    for row in range(b):
        e_end, e = jfo._follower_xla(jnp.asarray(x[row]), jnp.asarray(aa[row]),
                                     jnp.asarray(ra[row]), jnp.float32(env0[row]))
        np.testing.assert_allclose(env[row], np.asarray(e), atol=ATOL)
        np.testing.assert_allclose(env_end[row], float(e_end), atol=ATOL)


# the CUDA gate kernel's tile and its target ring of two tiles
# (csrc/follower.cu)
GATE_TILE = 1024


def _gate_edge_streams(b, n, kind, seed):
    """The gate's streams for one edge case of the kernel: "random" (as
    _gate_streams), "hold H" (hold_samples H), "flip" (an instant follower
    over 0 / -90 dB on alternate samples, no hold: open and closed on
    consecutive samples), "expire D" (an instant follower open up to a
    sample whose 100-sample hold ends D samples from the second tile's
    start, so the range first applies at sample GATE_TILE + D)."""
    x, aa, ra, thr, rng, hs = _gate_streams(b, n, seed)
    if kind.startswith("hold"):
        hs[:] = float(kind.split()[1])
    elif kind == "flip":
        x[:] = np.where(np.arange(n) % 2 == 0, 0.0, -90.0)
        aa[:], ra[:], hs[:] = 1.0, 1.0, 0.0
    elif kind.startswith("expire"):
        hold = 100
        last_open = GATE_TILE + int(kind.split()[1]) - hold - 1
        x[:] = -90.0
        x[:, :last_open + 1] = 0.0
        aa[:], ra[:], hs[:] = 1.0, 1.0, float(hold)
    return x, aa, ra, thr, rng, hs


@pytest.mark.parametrize("b,n", [(1, 1000), (3, 1000), (1, 4096), (3, 4096)])
def test_gate_matches_jax(b, n):
    streams = _gate_streams(b, n, seed=2 * n + b)
    st0 = np.stack([np.linspace(-120.0, -20.0, b), np.linspace(0.0, 100.0, b),
                    np.full(b, -60.0)], axis=-1).astype(np.float32)
    _check_gate(streams, st0)


@pytest.mark.parametrize("b,n,kind", [
    (1, 5, "random"), (1, GATE_TILE - 1, "random"), (1, GATE_TILE, "random"),
    (1, GATE_TILE + 1, "random"), (1, 2 * GATE_TILE - 1, "random"),
    (1, 2 * GATE_TILE, "random"), (1, 2 * GATE_TILE + 1, "random"),
    (2, 1100, "hold 0"), (2, 1100, "hold 1"), (1, 1101, "flip"),
    (1, 1100, "expire -1"), (1, 1100, "expire 0"), (1, 1100, "expire +1")])
def test_gate_edge_cases_match_jax(b, n, kind):
    """The CUDA gate kernel's edge cases (chip_smoke.py holds the kernel to
    gate_plain on them bit for bit): lengths at its tile and ring sizes and
    one off, holds of 0 and 1 sample, a gate that flips on every sample,
    holds that run out just before, at and after a tile boundary."""
    streams = _gate_edge_streams(b, n, kind, seed=3 * n + b)
    st0 = np.stack([np.linspace(-120.0, -20.0, b), np.linspace(0.0, 3.0, b),
                    np.full(b, -60.0)], axis=-1).astype(np.float32)
    _check_gate(streams, st0)


def _check_gate(streams, st0):
    """gate_plain against the float32 NumPy loop exactly, and against the
    JAX Pallas kernel (interpret mode) and XLA scan to ATOL."""
    b, n = streams[0].shape
    (env, hold, gain), gains = fo.gate_plain(*_t(*streams),
                                             *_t(*st0.T.copy()))
    got_state = np.stack([env.numpy(), hold.numpy(), gain.numpy()], axis=-1)
    gains = gains.numpy()

    want_state, want = _np_gate(*streams, *st0.T)
    assert np.array_equal(gains, want)
    assert np.array_equal(got_state, np.stack(want_state, axis=-1))

    kg, kst = jfo._gate_call(*(jnp.asarray(s) for s in streams),
                             jnp.asarray(st0), min(jfo._chunk_for(n), 1024))
    np.testing.assert_allclose(gains, np.asarray(kg), atol=ATOL)
    np.testing.assert_allclose(got_state, np.asarray(kst), atol=ATOL)
    for row in range(b):
        (e, h, g), xg = jfo._gate_xla(*(jnp.asarray(s[row]) for s in streams),
                                      *(jnp.float32(v) for v in st0[row]))
        np.testing.assert_allclose(gains[row], np.asarray(xg), atol=ATOL)
        np.testing.assert_allclose(got_state[row], [float(e), float(h), float(g)],
                                   atol=ATOL)


def test_split_block_carries_state():
    n, h = 4096, 1500
    x, aa, ra = _t(*_streams(3, n, seed=7))
    env0 = torch.tensor([-120.0, -50.0, 0.0])
    end, whole = fo.follower_plain(x, aa, ra, env0)
    mid, first = fo.follower_plain(x[:, :h], aa[:, :h], ra[:, :h], env0)
    end2, second = fo.follower_plain(x[:, h:], aa[:, h:], ra[:, h:], mid)
    assert torch.equal(whole, torch.cat([first, second], dim=-1))
    assert torch.equal(end, end2)

    streams = _t(*_gate_streams(3, n, seed=8))
    st0 = [torch.tensor(v) for v in ([-120.0] * 3, [0.0, 3.0, 500.0], [-60.0] * 3)]
    st, whole = fo.gate_plain(*streams, *st0)
    mid, first = fo.gate_plain(*(s[:, :h] for s in streams), *st0)
    st2, second = fo.gate_plain(*(s[:, h:] for s in streams), *mid)
    assert torch.equal(whole, torch.cat([first, second], dim=-1))
    assert all(torch.equal(a, b) for a, b in zip(st, st2))


def test_routing_by_device():
    """CPU tensors take the plain versions, broadcast streams included; the
    kernel wrappers refuse CPU tensors instead of falling back."""
    x, aa, ra = _t(*_streams(2, 300, seed=9))
    env0 = torch.tensor([-120.0, -30.0])
    end, env = fo.asym_follower(x, aa[:, :1], torch.tensor(0.002), env0)
    end2, env2 = fo.follower_plain(x, aa[:, :1].expand_as(x),
                                   torch.full_like(x, 0.002), env0)
    assert torch.equal(env, env2) and torch.equal(end, end2)
    launches = fo.follower_launches, fo.gate_launches
    with pytest.raises(ValueError, match="CUDA"):
        fo.follower(x, aa, ra, env0)
    with pytest.raises(ValueError, match="CUDA"):
        fo.gate(x, aa, ra, x, x, x, torch.zeros(2, 3))
    assert (fo.follower_launches, fo.gate_launches) == launches


def test_empty_block_keeps_state():
    x = torch.zeros(2, 0)
    env0 = torch.tensor([-120.0, -3.0])
    end, env = fo.follower_plain(x, x, x, env0)
    assert env.shape == (2, 0) and torch.equal(end, env0)
    (e, h, g), gains = fo.gate_plain(x, x, x, x, x, x, env0, env0, env0)
    assert gains.shape == (2, 0) and torch.equal(g, env0)


def test_envelope_coefficients_match_jax():
    """follower_alpha (-expm1 form) and follower_coef, instant at t <= 0:
    within 1 float32 ulp of the float64 function of the same float32
    argument, and 2 ulp of the JAX package's (XLA's float32 expm1 is 2 ulp
    off at t = 5 ms)."""
    t = np.float32([-1.0, 0.0, 1e-6, 0.001, 0.005, 0.02, 0.2, 2.0])
    x = (np.float32(-1.0) / np.maximum(t * np.float32(48000.0), np.float32(1e-9))
         ).astype(np.float64)
    exact = {envelope.follower_alpha: np.where(t > 0, -np.expm1(x), 1.0),
             envelope.follower_coef: np.where(t > 0, np.exp(x), 0.0)}
    for fn, jfn in ((envelope.follower_alpha, jenv.follower_alpha),
                    (envelope.follower_coef, jenv.follower_coef)):
        got = fn(torch.as_tensor(t), 48000).numpy()
        assert got.dtype == np.float32
        np.testing.assert_array_max_ulp(got, exact[fn].astype(np.float32), maxulp=1)
        np.testing.assert_array_max_ulp(
            got, np.asarray(jfn(jnp.asarray(t), 48000)), maxulp=2)


def test_hash_random_matches_jax():
    """The int64 emulation of the uint32 hash, across wraps and beyond
    2**31, for several seeds."""
    k = np.concatenate([np.arange(0, 4096), 2**31 - 5 + np.arange(10),
                        2**32 - 3 + np.arange(3),
                        np.random.default_rng(3).integers(0, 2**32, 4096)])
    for seed in (0, 0x5EED, 2**32 - 1):
        want = np.asarray(jlfo._hash_random(seed, jnp.asarray(k, jnp.uint32)))
        got = lfo._hash_random(seed, torch.as_tensor(k)).numpy()
        assert np.array_equal(got, want)


@pytest.mark.parametrize("waveform", range(7))
def test_lfo_waveforms_match_jax(waveform):
    """Each waveform over two blocks with the state carried, at a rate whose
    phase increments (2**-13 of a cycle) sum exactly in both packages; the
    start phase and wrap count put the random waveforms' counter near 2**31."""
    n = 4096
    inc = np.full(n, 2.0 ** -13 * 3, np.float32)
    jst = jlfo.LfoState(jnp.float32(0.25), jnp.int32(2**31 - 4))
    pst = lfo.LfoState(torch.tensor([0.25]), torch.tensor([2**31 - 4],
                                                          dtype=torch.int32))
    for _ in range(2):
        jst, want = jlfo.lfo_block(jst, jnp.int32(waveform), jnp.asarray(inc), n,
                                   seed=0x5EED)
        pst, got = lfo.lfo_block(pst, torch.as_tensor(inc)[None], n,
                                 waveform=torch.tensor([waveform]), seed=0x5EED)
        assert np.array_equal(got[0].numpy(), np.asarray(want))
        assert float(pst.phase[0]) == float(jst.phase)
        assert int(pst.wraps[0]) == int(jst.wraps)


def test_lfo_per_row_waveforms_and_sine_default():
    """Rows pick their own waveform; with no waveform the LFO is the sine
    the chorus uses."""
    assert lfo.WAVEFORM_NAMES == jlfo.WAVEFORM_NAMES
    n = 1000
    inc = torch.full((3, n), 1.0 / 48000.0)
    st = lfo.LfoState(torch.tensor([0.0, 0.1, 0.7]),
                      torch.zeros(3, dtype=torch.int32))
    _, sine = lfo.lfo_block(st, inc, n)
    _, picked = lfo.lfo_block(st, inc, n, waveform=torch.tensor([0, 4, 2]))
    assert torch.equal(picked[0], sine[0])
    for row, wf in ((1, 4), (2, 2)):
        one = lfo.LfoState(st.phase[row:row + 1], st.wraps[row:row + 1])
        _, alone = lfo.lfo_block(one, inc[row:row + 1], n,
                                 waveform=torch.tensor([wf]))
        assert torch.equal(picked[row], alone[0])
