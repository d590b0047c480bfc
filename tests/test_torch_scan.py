"""phonic_tpu_torch/ops/scan.py against the JAX package and a float64 loop.

The port's recurrences (their plain, chunked versions on the CPU; the CUDA
kernels csrc/scan.cu on a card) must match
  * the JAX Pallas kernels ``pallas_scan.iir1_scan`` / ``iir2_scan`` in
    interpret mode (T <= 2048, as tests/test_pallas_scan.py keeps them),
  * JAX ``linear_recurrence`` / ``linear_recurrence_2`` at T >= 4096, where
    they take their own chunked path,
  * a float64 numpy loop,
to within -90 dB of the output peak.  Association order differs between
all of them, so agreement is to float32 rounding, not bit for bit.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from phonic_tpu.ops import pallas_scan as jpallas
from phonic_tpu.ops import scan as jscan
from phonic_tpu_torch.ops import scan

DB90 = 10.0 ** (-90.0 / 20.0)


def _mk1(r, t, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 0.999, (r, t)).astype(np.float32)
    b = rng.normal(size=(r, t)).astype(np.float32)
    y0 = rng.normal(size=(r,)).astype(np.float32)
    return a, b, y0


def _mk2(r, t, seed):
    rng = np.random.default_rng(seed)
    a11 = rng.uniform(0.7, 0.95, (r, t)).astype(np.float32)
    a12 = rng.uniform(-0.2, 0.2, (r, t)).astype(np.float32)
    a21 = rng.uniform(-0.2, 0.2, (r, t)).astype(np.float32)
    a22 = rng.uniform(0.7, 0.95, (r, t)).astype(np.float32)
    b1 = rng.normal(size=(r, t)).astype(np.float32)
    b2 = rng.normal(size=(r, t)).astype(np.float32)
    s01 = rng.normal(size=(r,)).astype(np.float32)
    s02 = rng.normal(size=(r,)).astype(np.float32)
    return a11, a12, a21, a22, b1, b2, s01, s02


def _loop1(a, b, y0):
    a, b = a.astype(np.float64), b.astype(np.float64)
    y = np.empty_like(b)
    c = y0.astype(np.float64)
    for n in range(b.shape[-1]):
        c = a[:, n] * c + b[:, n]
        y[:, n] = c
    return y


def _loop2(a11, a12, a21, a22, b1, b2, s01, s02):
    x1, x2 = s01.astype(np.float64), s02.astype(np.float64)
    o1, o2 = np.empty(b1.shape), np.empty(b1.shape)
    for n in range(b1.shape[-1]):
        x1, x2 = (a11[:, n] * x1 + a12[:, n] * x2 + b1[:, n],
                  a21[:, n] * x1 + a22[:, n] * x2 + b2[:, n])
        o1[:, n], o2[:, n] = x1, x2
    return o1, o2


def _close(got, want):
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= DB90 * np.abs(want).max()


def _port1(a, b, y0):
    return scan.linear_recurrence(torch.as_tensor(a), torch.as_tensor(b),
                                  torch.as_tensor(y0)).numpy()


def _port2(args):
    s1, s2 = scan.linear_recurrence_2(*(torch.as_tensor(x) for x in args))
    return s1.numpy(), s2.numpy()


@pytest.mark.parametrize("r,t", [(2, 1), (3, 130), (5, 700), (2, 2048)])
def test_first_order_matches_pallas_kernel(r, t):
    a, b, y0 = _mk1(r, t, seed=t)
    got = _port1(a, b, y0)
    _close(got, np.asarray(jpallas.iir1_scan(jnp.asarray(a), jnp.asarray(b),
                                             jnp.asarray(y0))))
    _close(got, _loop1(a, b, y0))


@pytest.mark.parametrize("r,t", [(2, 1), (3, 500), (8, 2048)])
def test_second_order_matches_pallas_kernel(r, t):
    args = _mk2(r, t, seed=t)
    s1, s2 = _port2(args)
    j1, j2 = jpallas.iir2_scan(*(jnp.asarray(x) for x in args))
    _close(s1, np.asarray(j1))
    _close(s2, np.asarray(j2))
    l1, l2 = _loop2(*args)
    _close(s1, l1)
    _close(s2, l2)


@pytest.mark.parametrize("r,t", [(2, 4096), (7, 4999), (2, 16384)])
def test_first_order_matches_chunked_jax(r, t):
    a, b, y0 = _mk1(r, t, seed=t)
    got = _port1(a, b, y0)
    _close(got, np.asarray(jscan.linear_recurrence(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(y0))))
    _close(got, _loop1(a, b, y0))


@pytest.mark.parametrize("r,t", [(8, 4096), (2, 4097), (3, 16384)])
def test_second_order_matches_chunked_jax(r, t):
    args = _mk2(r, t, seed=t)
    s1, s2 = _port2(args)
    j1, j2 = jscan.linear_recurrence_2(*(jnp.asarray(x) for x in args))
    _close(s1, np.asarray(j1))
    _close(s2, np.asarray(j2))
    l1, l2 = _loop2(*args)
    _close(s1, l1)
    _close(s2, l2)


def test_broadcast_and_axis():
    """Coefficients broadcast against the input and the recurrence may run
    along any axis, as in the JAX API."""
    rng = np.random.default_rng(11)
    b = rng.normal(size=(3, 64, 2)).astype(np.float32)
    a = np.float32(0.97)
    y0 = rng.normal(size=(3, 2)).astype(np.float32)
    got = scan.linear_recurrence(torch.tensor(a), torch.as_tensor(b),
                                 torch.as_tensor(y0), axis=1).numpy()
    want = np.asarray(jscan.linear_recurrence(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(y0), axis=1))
    _close(got, want)


def test_cpu_tensors_take_the_plain_version():
    """CPU tensors never reach a kernel: the launch counters stay put and
    the kernel wrappers refuse CPU tensors."""
    a, b, y0 = _mk1(2, 300, seed=3)
    before = (scan.iir1_launches, scan.iir2_launches)
    _port1(a, b, y0)
    _port2(_mk2(2, 300, seed=4))
    assert (scan.iir1_launches, scan.iir2_launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        scan.iir1(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(y0))
    with pytest.raises(ValueError, match="CUDA"):
        scan.iir2(*(torch.as_tensor(x) for x in _mk2(2, 300, seed=4)))
