"""Linear recurrences (port of ``phonic_tpu/ops/scan.py``).

The substrate of every recursive DSP unit on the slice (the EQ biquads, the
chorus SVF, the reverb lowpasses, the DC blocker): a first- or second-order
recurrence ``s[n] = A[n] s[n-1] + b[n]`` with per-sample coefficients.

Routing is by the device of the tensors:

- CUDA tensors run the hand-written kernels in ``csrc/scan.cu``
  (:func:`iir1` / :func:`iir2`), always, or raise.  Each call is one launch
  of a single-pass scan with decoupled look-back, whose flags and records
  live in a scratch kept per kernel, device and stream (:func:`_scan_epoch`);
- CPU tensors run the plain PyTorch versions, the two-level chunked
  evaluation :func:`chunked_first` / :func:`chunked_second` (the same
  algorithm as the JAX package's ``_chunked_first`` / ``_chunked_second``).
"""

from __future__ import annotations

import torch

from .. import kernels
from . import consts

# kernel launch counts (one per wrapper call that launched its kernel)
iir1_launches = 0
iir2_launches = 0

# The look-back scratch per (kernel, device, stream): [int32 tensor, last
# epoch].  Zeroed once when allocated or grown; each call then tags its
# flags with a new epoch instead of clearing them.  The two kernels lay out
# their records differently, so they never share a buffer.
_scan_scratch: dict = {}
_EPOCHS = 1 << 30


def _chunk_split(t: int) -> int:
    """Within-chunk length L ~ sqrt(t) (power of two), minimising the total
    sequential steps L + ceil(t/L) of the two-level evaluation."""
    return 1 << (t.bit_length() // 2)


def _pad_time(x: torch.Tensor, pad: int, value: float) -> torch.Tensor:
    if pad == 0:
        return x
    return torch.nn.functional.pad(x, (0, pad), value=value)


def chunked_first(a: torch.Tensor, b: torch.Tensor, y0) -> torch.Tensor:
    """Plain version of :func:`iir1`: ``y[n] = a[n] y[n-1] + b[n]`` along the
    last axis.  T is reshaped into [M, L] chunks; a loop over L runs every
    chunk from zero state (carrying the cumulative coefficient product), a
    loop over M threads the chunk-boundary states, and an elementwise
    combine restores the exact solution ``y[m, l] = w[m, l] + p[m, l] c[m-1]``.
    """
    t = b.shape[-1]
    l = _chunk_split(t)
    m = -(-t // l)
    a = _pad_time(a, m * l - t, 1.0)
    b = _pad_time(b, m * l - t, 0.0)
    lead = b.shape[:-1]
    ar = a.reshape(lead + (m, l)).movedim(-1, 0)  # [L, ..., M]
    br = b.reshape(lead + (m, l)).movedim(-1, 0)
    w = torch.zeros_like(br[0])
    p = torch.ones_like(ar[0])
    ws, ps = [], []
    for i in range(l):
        w = ar[i] * w + br[i]
        p = p * ar[i]
        ws.append(w)
        ps.append(p)
    c = torch.as_tensor(y0, dtype=b.dtype, device=b.device).expand(lead)
    cs = [c]
    for j in range(m - 1):
        c = p[..., j] * c + w[..., j]
        cs.append(c)
    c_prev = torch.stack(cs, dim=-1)  # [..., M]: state entering chunk m
    y = torch.stack(ws) + torch.stack(ps) * c_prev
    return y.movedim(0, -1).reshape(lead + (m * l,))[..., :t]


def chunked_second(a11, a12, a21, a22, b1, b2, s0_1, s0_2):
    """Plain version of :func:`iir2`: the 2-vector recurrence along the last
    axis by the same two-level evaluation as :func:`chunked_first`; the
    cumulative coefficient is a 2x2 matrix product tracked as four scalars.
    Pads are A = I, b = 0."""
    t = b1.shape[-1]
    l = _chunk_split(t)
    m = -(-t // l)
    pad = m * l - t
    a11, a22 = _pad_time(a11, pad, 1.0), _pad_time(a22, pad, 1.0)
    a12, a21 = _pad_time(a12, pad, 0.0), _pad_time(a21, pad, 0.0)
    b1, b2 = _pad_time(b1, pad, 0.0), _pad_time(b2, pad, 0.0)
    lead = b1.shape[:-1]
    c11, c12, c21, c22, d1, d2 = (
        x.reshape(lead + (m, l)).movedim(-1, 0)
        for x in (a11, a12, a21, a22, b1, b2))
    z = torch.zeros_like(d1[0])
    one = torch.ones_like(c11[0])
    w1, w2, p11, p12, p21, p22 = z, z, one, 0.0 * one, 0.0 * one, one
    seq = []
    for i in range(l):
        w1, w2 = (c11[i] * w1 + c12[i] * w2 + d1[i],
                  c21[i] * w1 + c22[i] * w2 + d2[i])
        p11, p12, p21, p22 = (c11[i] * p11 + c12[i] * p21,
                              c11[i] * p12 + c12[i] * p22,
                              c21[i] * p11 + c22[i] * p21,
                              c21[i] * p12 + c22[i] * p22)
        seq.append((w1, w2, p11, p12, p21, p22))
    x1 = torch.as_tensor(s0_1, dtype=b1.dtype, device=b1.device).expand(lead)
    x2 = torch.as_tensor(s0_2, dtype=b2.dtype, device=b2.device).expand(lead)
    c1s, c2s = [x1], [x2]
    for j in range(m - 1):
        x1, x2 = (p11[..., j] * x1 + p12[..., j] * x2 + w1[..., j],
                  p21[..., j] * x1 + p22[..., j] * x2 + w2[..., j])
        c1s.append(x1)
        c2s.append(x2)
    c1 = torch.stack(c1s, dim=-1)
    c2 = torch.stack(c2s, dim=-1)
    ws1, ws2, ps11, ps12, ps21, ps22 = (torch.stack(s) for s in zip(*seq))
    s1 = ws1 + ps11 * c1 + ps12 * c2
    s2 = ws2 + ps21 * c1 + ps22 * c2
    s1 = s1.movedim(0, -1).reshape(lead + (m * l,))[..., :t]
    s2 = s2.movedim(0, -1).reshape(lead + (m * l,))[..., :t]
    return s1, s2


def iir1(a: torch.Tensor, b: torch.Tensor, y0: torch.Tensor) -> torch.Tensor:
    """Kernel 3 (``csrc/scan.cu``): ``y[n] = a[n] y[n-1] + b[n]`` over
    contiguous float32 CUDA streams ``a``, ``b`` [R, T] from ``y0`` [R], in
    one launch."""
    global iir1_launches
    for x, name in ((a, "a"), (b, "b")):
        kernels.require(x, f"iir1 {name}", ndim=2, device=b.device)
    kernels.require(y0, "iir1 y0", ndim=1, device=b.device)
    r, t = b.shape
    if a.shape != b.shape or y0.shape[0] != r:
        raise ValueError(f"iir1: shapes a {tuple(a.shape)}, b {tuple(b.shape)},"
                         f" y0 {tuple(y0.shape)}")
    if not 0 < r <= 65535:
        raise ValueError(f"iir1: {r} rows (1..65535 supported)")
    out = torch.empty_like(b)
    if t == 0:
        return out
    lib = kernels.library()
    stream = kernels.stream_handle(b)
    scratch, epoch = _scan_epoch("iir1", b.device, stream,
                                 lib.phonic_iir1_scratch(r, t))
    err = lib.phonic_iir1(b.device.index, a.data_ptr(), b.data_ptr(),
                          y0.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                          scratch.numel(), r, t, epoch, stream)
    kernels.check(err, "iir1")
    iir1_launches += 1
    return out


def _scan_epoch(kernel: str, device, stream: int, words: int):
    """The look-back scratch of ``kernel`` on ``stream`` with at least
    ``words`` 32-bit words, and the epoch of the next call on it."""
    entry = _scan_scratch.get((kernel, device, stream))
    if entry is None or entry[0].numel() < words:
        entry = [torch.zeros(words, dtype=torch.int32, device=device), 0]
        _scan_scratch[(kernel, device, stream)] = entry
    entry[1] += 1
    if entry[1] == _EPOCHS:  # flags of 2**30 calls ago would match again
        entry[0].zero_()
        entry[1] = 1
    return entry[0], entry[1]


def iir2(a11, a12, a21, a22, b1, b2, s0_1, s0_2):
    """Kernel 2 (``csrc/scan.cu``): ``s[n] = A[n] s[n-1] + b[n]`` over six
    contiguous float32 CUDA streams [R, T] from ``(s0_1, s0_2)`` [R], in one
    launch.  Returns (s1, s2), each [R, T]."""
    global iir2_launches
    streams = (a11, a12, a21, a22, b1, b2)
    for x, name in zip(streams, ("a11", "a12", "a21", "a22", "b1", "b2")):
        kernels.require(x, f"iir2 {name}", ndim=2, device=b1.device)
        if x.shape != b1.shape:
            raise ValueError(f"iir2 {name}: shape {tuple(x.shape)}, "
                             f"expected {tuple(b1.shape)}")
    r, t = b1.shape
    for x, name in ((s0_1, "s0_1"), (s0_2, "s0_2")):
        kernels.require(x, f"iir2 {name}", ndim=1, device=b1.device)
        if x.shape[0] != r:
            raise ValueError(f"iir2 {name}: {x.shape[0]} rows, expected {r}")
    if not 0 < r <= 65535:
        raise ValueError(f"iir2: {r} rows (1..65535 supported)")
    out1 = torch.empty_like(b1)
    out2 = torch.empty_like(b1)
    if t == 0:
        return out1, out2
    lib = kernels.library()
    stream = kernels.stream_handle(b1)
    scratch, epoch = _scan_epoch("iir2", b1.device, stream,
                                 lib.phonic_iir2_scratch(r, t))
    err = lib.phonic_iir2(b1.device.index, *(x.data_ptr() for x in streams),
                          s0_1.data_ptr(), s0_2.data_ptr(), out1.data_ptr(),
                          out2.data_ptr(), scratch.data_ptr(), scratch.numel(),
                          r, t, epoch, stream)
    kernels.check(err, "iir2")
    iir2_launches += 1
    return out1, out2


def _rows(x: torch.Tensor, lead, t: int) -> torch.Tensor:
    return x.expand(lead + (t,)).reshape(-1, t).contiguous()


def linear_recurrence(a, b, y0, axis: int = -1) -> torch.Tensor:
    """Solve ``y[n] = a[n] * y[n-1] + b[n]`` with ``y[-1] = y0``.

    a, b: broadcastable tensors with the recurrence along ``axis``; y0: the
    initial state, shaped (or broadcastable) like them without ``axis``.
    Returns y with the broadcast shape."""
    a, b = torch.broadcast_tensors(a, b)
    a, b = a.movedim(axis, -1), b.movedim(axis, -1)
    lead, t = b.shape[:-1], b.shape[-1]
    if b.is_cuda:
        y0 = consts.as_device(y0, b.dtype, b.device)
        y = iir1(_rows(a, lead, t), _rows(b, lead, t),
                 y0.expand(lead).reshape(-1).contiguous()).reshape(lead + (t,))
    else:
        y = chunked_first(a, b, y0)
    return y.movedim(-1, axis)


def linear_recurrence_2(a11, a12, a21, a22, b1, b2, s0_1, s0_2,
                        axis: int = -1):
    """Solve the 2-vector recurrence ``s[n] = A[n] s[n-1] + b[n]``.

    All six coefficient tensors broadcast together and share the recurrence
    ``axis``.  Returns (s1, s2) along the axis."""
    arrs = [x.movedim(axis, -1)
            for x in torch.broadcast_tensors(a11, a12, a21, a22, b1, b2)]
    lead, t = arrs[4].shape[:-1], arrs[4].shape[-1]
    if arrs[4].is_cuda:
        dev, dt = arrs[4].device, arrs[4].dtype
        s0 = [consts.as_device(s, dt, dev).expand(lead)
              .reshape(-1).contiguous() for s in (s0_1, s0_2)]
        s1, s2 = iir2(*(_rows(x, lead, t) for x in arrs), *s0)
        s1, s2 = s1.reshape(lead + (t,)), s2.reshape(lead + (t,))
    else:
        s1, s2 = chunked_second(*arrs, s0_1, s0_2)
    return s1.movedim(-1, axis), s2.movedim(-1, axis)
