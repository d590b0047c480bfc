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


# beside the kernel's segment (4096 samples) and one off, odd lengths (rows
# that start unaligned), one row and forty
@pytest.mark.parametrize("r,t", [(2, 1), (3, 500), (8, 2048), (1, 4095),
                                 (1, 4096), (1, 4097), (3, 999), (40, 777)])
def test_second_order_matches_pallas_kernel(r, t):
    args = _mk2(r, t, seed=t)
    s1, s2 = _port2(args)
    j1, j2 = jpallas.iir2_scan(*(jnp.asarray(x) for x in args))
    _close(s1, np.asarray(j1))
    _close(s2, np.asarray(j2))
    l1, l2 = _loop2(*args)
    _close(s1, l1)
    _close(s2, l2)


# rows past two of the kernel's 4096-sample segments
@pytest.mark.parametrize("r,t", [(2, 4096), (7, 4999), (2, 16384), (1, 8193),
                                 (3, 8193)])
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


def _check_scratch_epochs(kernel):
    """The look-back scratch of ``kernel`` is zeroed only when allocated,
    grown or when the 30-bit epoch would wrap; every other call gets the
    next epoch."""
    dev = torch.device("cpu")
    key = (kernel, dev, 12345)
    scan._scan_scratch.pop(key, None)
    buf, epoch = scan._scan_epoch(kernel, dev, 12345, 100)
    assert epoch == 1 and buf.numel() == 100 and not buf.any()
    buf.fill_(7)
    again, epoch = scan._scan_epoch(kernel, dev, 12345, 50)
    assert epoch == 2 and again is buf and bool((buf == 7).all())
    grown, epoch = scan._scan_epoch(kernel, dev, 12345, 200)
    assert epoch == 1 and grown.numel() == 200 and not grown.any()
    grown.fill_(7)
    scan._scan_scratch[key][1] = scan._EPOCHS - 1
    same, epoch = scan._scan_epoch(kernel, dev, 12345, 200)
    assert same is grown and epoch == 1 and not grown.any()
    scan._scan_scratch.pop(key)


def test_iir2_scratch_epochs():
    _check_scratch_epochs("iir2")


def test_iir1_scratch_epochs():
    """iir1's scratch keeps the same epochs, and never shares a buffer or an
    epoch count with iir2's on the same device and stream: the two kernels
    lay out their records differently."""
    _check_scratch_epochs("iir1")
    dev = torch.device("cpu")
    one, e1 = scan._scan_epoch("iir1", dev, 777, 64)
    two, e2 = scan._scan_epoch("iir2", dev, 777, 64)
    assert one is not two and e1 == e2 == 1
    one.fill_(5)
    assert not two.any()
    again, e1 = scan._scan_epoch("iir1", dev, 777, 64)
    assert again is one and e1 == 2
    assert scan._scan_epoch("iir2", dev, 777, 64) == (two, 2)
    for kernel in ("iir1", "iir2"):
        scan._scan_scratch.pop((kernel, dev, 777))
