"""phonic_tpu_torch/ops/rampread.py against the JAX package.

The port's batched Hermite read (its plain version on the CPU; the CUDA
kernel csrc/rampread.cu on a card) must match the JAX Pallas kernel
``phonic_tpu.ops.rampread.ramp_read`` (run in interpret mode, as
tests/test_rampread.py runs it) and ``phonic_tpu.ops.resample.hermite_read``
for the cases of tests/test_rampread.py: plain ramps, out-of-range
positions, loop / pingpong / reverse folds, ragged lengths and multi-source
stereo tables.  Tolerance: 1e-5 absolute on unit-scale data (the JAX kernel
sums per-tap weights where hermite_read evaluates the x-form; both orders
round differently by a few ulp).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phonic_tpu.ops import rampread as jrr
from phonic_tpu.ops.resample import hermite_read as jhermite_read
from phonic_tpu_torch import tracing
from phonic_tpu_torch.ops import rampread

TOL = 1e-5


def _port(src, smap, pos):
    return rampread.ramp_read(torch.as_tensor(src),
                              torch.as_tensor(np.asarray(smap, np.int32)),
                              torch.as_tensor(pos)).numpy()


def _jax_hermite(src, smap, pos):
    return np.stack([np.asarray(jhermite_read(jnp.asarray(src[smap[b]]),
                                              jnp.asarray(pos[b])))
                     for b in range(pos.shape[0])])


def _jax_kernel(src, smap, pos, smax):
    packed = jnp.asarray(jrr.pack(src, min_rows=jrr.window_rows(1024, smax)))
    return np.asarray(jrr.ramp_read(packed, np.asarray(smap, np.int32),
                                    jnp.asarray(pos), smax=smax,
                                    interpret=True))


def _check(src, smap, pos, smax, kernel=True):
    out = _port(src, smap, pos)
    assert out.shape == (pos.shape[0], src.shape[1], pos.shape[1])
    assert np.abs(out - _jax_hermite(src, smap, pos)).max() <= TOL
    if kernel:
        assert np.abs(out - _jax_kernel(src, smap, pos, smax)).max() <= TOL
    return out


def test_matches_jax_basic():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(3, 2, 9000)).astype(np.float32)
    smap = [0, 1, 2, 0]
    pos = np.cumsum(rng.uniform(0.2, 2.0, (4, 4096)), -1).astype(np.float32)
    pos += rng.uniform(0, 100, (4, 1)).astype(np.float32)
    _check(src, smap, pos, smax=2)


def test_out_of_range_positions_read_zero():
    rng = np.random.default_rng(1)
    src = rng.normal(size=(1, 1, 2000)).astype(np.float32)
    pos = np.linspace(-40.0, 2040.0, 1500, dtype=np.float32)[None]
    out = _check(src, [0], pos, smax=2)
    assert np.all(out[0, 0, pos[0] < -3.0] == 0.0)
    assert np.all(out[0, 0, pos[0] > 2002.0] == 0.0)


@pytest.mark.parametrize("kind", ["forward", "loop_short", "loop_long",
                                  "pingpong", "reverse"])
def test_folds_and_direction(kind):
    rng = np.random.default_rng(len(kind))
    src = rng.normal(size=(1, 1, 3000)).astype(np.float32)
    n = 2500
    steps = rng.uniform(0.1, 4.0, n)
    p = 2900.0 - np.cumsum(steps) * 0.2 if kind == "reverse" else (
        np.cumsum(steps) + 10.0)
    if kind in ("loop_short", "loop_long"):
        ls, le = (500.0, 800.0) if kind == "loop_short" else (100.0, 2900.0)
        p = np.where(p < ls, p, ls + np.mod(p - ls, le - ls))
    elif kind == "pingpong":
        ls, le = 200.0, 1400.0
        c = np.mod(p - ls, 2 * (le - ls))
        p = np.where(p < ls, p,
                     ls + np.where(c < le - ls, c, 2 * (le - ls) - c))
    # the Pallas interpreter costs seconds per call: the kernel comparison
    # runs on the two folds its two-slice windows exist for
    _check(src, [0], p[None].astype(np.float32), smax=4,
           kernel=kind in ("loop_short", "pingpong"))


@pytest.mark.parametrize("n", [1, 37, 129, 1000, 2049])
def test_ragged_length(n):
    rng = np.random.default_rng(n)
    src = rng.normal(size=(1, 1, 700)).astype(np.float32)
    p = np.cumsum(rng.uniform(0.1, 4.0, n)) + 300.0
    ls, le = 100.0, 620.0
    p = np.where(p < ls, p, ls + np.mod(p - ls, le - ls))
    # the Pallas interpreter costs seconds per shape: one ragged shape
    _check(src, [0], p[None].astype(np.float32), smax=4, kernel=(n == 129))


def test_multi_source_batch_and_stereo():
    rng = np.random.default_rng(4)
    src = rng.normal(size=(4, 2, 5000)).astype(np.float32)
    smap = [2, 0, 3, 1, 2, 2]
    pos = (np.cumsum(rng.uniform(0.3, 1.0, (6, 3000)), -1)
           + rng.uniform(0, 1000, (6, 1))).astype(np.float32)
    _check(src, smap, pos, smax=1)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper runs the plain version and launches
    nothing; the kernel's operand checks reject CPU tensors."""
    rng = np.random.default_rng(5)
    src = torch.as_tensor(rng.normal(size=(2, 1, 500)).astype(np.float32))
    smap = torch.tensor([1, 0], dtype=torch.int32)
    pos = torch.as_tensor(rng.uniform(0, 499, (2, 64)).astype(np.float32))
    tracing.reset()
    tracing.enable()
    try:
        out = rampread.ramp_read(src, smap, pos)
        assert tracing.counters().get("kernel.ramp_read", 0) == 0
    finally:
        tracing.disable()
    assert torch.equal(out, rampread.ramp_read_plain(src, smap, pos))
    from phonic_tpu_torch import kernels
    with pytest.raises(ValueError, match="CUDA"):
        kernels.require(pos, "positions", ndim=2)
