"""The reverb's delay network: the loops of ``ReverbEffect`` that read its
delay lines (port of the two loops over sub-blocks in
``phonic_tpu/effects/reverb.py``).

For every lane and channel, sample t of a block runs the driven input
through four chained Schroeder allpasses (``w = x - 0.5 w[t - d_a]``,
``y = 0.5 w + w[t - d_a]``, g = 0.5) and feeds their outputs into 8 delay
lines, each read with a vibrato-modulated fractional tap and coupled to its
group of 4 by a Householder feedback with a one-sample lag; the output is
the mean of the 8 reads.  Channels never couple.  Everything that does not
read a line (the predelay, the three lowpasses with their ``sin`` /
``asin``, the derived controls, the reset flush, the vibrato phase wrap)
stays in the effect, vectorised over the block; this module takes its
per-sample streams.

Routing is by the device of the tensors:

- CUDA tensors run the hand-written kernel in ``csrc/reverb.cu``
  (:func:`network_kernel`), one launch per block, always, or raise;
- CPU tensors run :func:`network_plain`, a loop over allpass sub-blocks of
  ``b_ap`` samples and one over FDN sub-blocks of ``b_fdn``, each read from
  the windows before it and rolled in after.

A sub-block reads only samples written before it when ``b_ap`` is at most
the smallest allpass delay and ``b_fdn`` at most the smallest line delay
less 15 (the vibrato reads up to 15 samples newer than the line's delay).
Nothing in the network sums over samples, so any such sub-blocks give the
same result bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels, tracing
from . import consts

# per-line vibrato depths (reverb.rs:105-151), its speed and its depth in
# samples
VIB_DEPTHS = np.array([0.003251, 0.002999, 0.002917, 0.002749,
                       0.002503, 0.002423, 0.002146, 0.002088])
VIB_SPEED = 0.1
VIB_DEPTH = 7.0
# the read's newest tap lies this many samples after the line's delay
VIB_SPAN = 15


def vib_increments(dtype, device) -> torch.Tensor:
    """Each line's vibrato phase increment per sample, [8]."""
    return consts.const(VIB_DEPTHS * VIB_SPEED, dtype, device)


def _sum_in_order(terms):
    """``((t0 + t1) + t2) + ...``: the order ``torch.sum`` and
    ``torch.mean`` take over the lines on the CPU at sub-blocks of 16
    samples or more, and the kernel's; written out, it holds at every
    sub-block (at 1, 4 or 8 samples the CPU's reductions reassociate)."""
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total


def network_plain(drive_in, ap_delay, line_delay, blend, regen, vib_phase,
                  ap_buf, line_buf, fb, b_ap: int, b_fdn: int,
                  dtype=torch.float32):
    """Plain version of :func:`network_kernel`: the allpass chain in one
    loop over sub-blocks of ``b_ap`` samples, the FDN in one over
    sub-blocks of ``b_fdn`` (``lax.scan`` in the JAX package)."""
    dt = dtype
    n = drive_in.shape[-1]
    lanes = drive_in.shape[0]
    dev = drive_in.device

    # ---- 4 cascaded allpasses in one loop over sub-blocks --------------
    # Within a sub-block (< min allpass delay), stage a+1's sample j
    # depends only on stage a's sample j and its own older history, so
    # all four stages chain inside one step.  Window index of an
    # absolute delay d is H - d; one gather reads all four stages.
    h_ap = ap_buf.shape[-1]
    ap_idx = ((h_ap - ap_delay)[:, :, None, None]
              + torch.arange(b_ap, device=dev)).expand(lanes, 4, 2, b_ap)
    buf4 = ap_buf  # [G, 4, 2, H]
    outs = []
    for t0 in range(0, n, b_ap):
        sig = drive_in[..., t0:t0 + b_ap].to(dt)
        delayed = torch.gather(buf4, -1, ap_idx)  # [G, 4, 2, B]
        writes, stage_outs = [], []
        for a in range(4):
            w = sig - delayed[:, a] * 0.5
            sig = w * 0.5 + delayed[:, a]
            writes.append(w)
            stage_outs.append(sig)
        buf4 = torch.cat([buf4[..., b_ap:], torch.stack(writes, dim=1)],
                         dim=-1)
        outs.append(torch.stack(stage_outs, dim=1))
    stages = torch.cat(outs, dim=-1)  # [G, 4, 2, n]
    ap_i, ap_j, ap_k, ap_l = stages.unbind(1)

    # FDN line inputs (reverb.rs:275-283): a/h <- allpass L, b/g <- K,
    # c/f <- J, d/e <- I
    line_in = torch.stack([ap_l, ap_k, ap_j, ap_i, ap_i, ap_j, ap_k, ap_l],
                          dim=1)  # [G, 8, 2, n]

    # ---- 8-line vibrato FDN in one loop over sub-blocks ----------------
    # The read for output sample t is buf[t - delay + floor(offset)] with
    # the fraction interpolating one sample newer; offset = (sin+1)*7
    # lies in [0, 14].  Reads happen after the reference's step()
    # (reverb.rs:284-301, 554-586): the vibrato phase is advanced once.
    vib_inc = vib_increments(dt, dev)
    vib_inc3 = vib_inc[:, None, None]
    h_ln = line_buf.shape[-1]
    base_idx = (h_ln - line_delay)[:, :, None, None]  # [G, 8, 1, 1]
    j = torch.arange(b_fdn, device=dev)
    vib_base = vib_phase[..., None]  # phase at block start
    buf = line_buf  # [G, 8, 2, H], fb [G, 8, 2]
    wet_parts = []
    for t0 in range(0, n, b_fdn):
        vib = vib_base + vib_inc3 * (t0 + j).to(dt)  # [G, 8, 2, B]
        # floor(offset) picks the tap, so the read jumps where the
        # offset crosses an integer.  A float32 sine differs by an ulp
        # or two between CPU and CUDA libraries, enough to pick another
        # tap now and then; a float64 sine rounded to float32 is the
        # same on both but with a vanishing probability, so CPU and
        # CUDA renders pick the same taps
        vib_sin = torch.sin((vib + vib_inc3).double()).to(dt)
        offset = (vib_sin + 1.0) * VIB_DEPTH
        off_floor = torch.floor(offset)
        w_frac = offset - off_floor
        gidx = base_idx + j + off_floor.to(torch.int64)
        v1 = torch.gather(buf, -1, gidx)
        v2 = torch.gather(buf, -1, gidx + 1)
        bl = blend[:, None, None, t0:t0 + b_fdn]
        interp = (1.0 - bl) * (v1 * (1.0 - w_frac) + v2 * w_frac) + v1 * bl

        # cross-line feedback (Householder 4-groups), 1-sample lag
        rg = regen[:, None, None, t0:t0 + b_fdn]
        lines = interp.unbind(1)
        g1 = _sum_in_order(lines[:4])[:, None]
        g2 = _sum_in_order(lines[4:])[:, None]
        gsum = torch.cat([g1.expand(-1, 4, -1, -1),
                          g2.expand(-1, 4, -1, -1)], dim=1)
        fb_now = (2.0 * interp - gsum) * rg  # [G, 8, 2, B]
        fb_prev = torch.cat([fb[..., None], fb_now[..., :-1]], dim=-1)
        writes = (line_in[..., t0:t0 + b_fdn] + fb_prev).to(dt)
        buf = torch.cat([buf[..., b_fdn:], writes], dim=-1)
        fb = fb_now[..., -1]
        # the mean of the 8 lines: [G, 2, B]
        wet_parts.append(_sum_in_order((g1[:, 0],) + lines[4:]) / 8.0)
    wet_sig = torch.cat(wet_parts, dim=-1)
    return wet_sig, buf4, buf, fb


def _operand(t: torch.Tensor, what: str, shape, device,
             dtype=torch.float32) -> None:
    kernels.require(t, what, ndim=len(shape), dtype=dtype, device=device)
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _window(t: torch.Tensor, what: str, lead, device) -> int:
    """A window [*lead, H] of a power-of-two H; returns H."""
    kernels.require(t, what, ndim=len(lead) + 1, device=device)
    h = t.shape[-1]
    if tuple(t.shape[:-1]) != tuple(lead) or h < 2 or h & (h - 1):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected "
                         f"{tuple(lead)} + (a power of two,)")
    return h


def network_kernel(drive_in, ap_delay, line_delay, blend, regen, vib_phase,
                   ap_buf, line_buf, fb, dtype=torch.float32):
    """Kernel 8 (``csrc/reverb.cu``): the block in one launch.
    ``drive_in`` [G, 2, n]; the block-rate delays ``ap_delay`` [G, 4] and
    ``line_delay`` [G, 8] (int64); ``blend`` and ``regen`` [G, n]; the
    vibrato phase at block start ``vib_phase`` [G, 8, 2]; the windows
    ``ap_buf`` [G, 4, 2, H_ap] and ``line_buf`` [G, 8, 2, H_ln] (powers of
    two, newest sample last); the feedback state ``fb`` [G, 8, 2].  All
    contiguous CUDA tensors on one card, float32 where not int64.  The
    kernel's tiles follow the delays it reads on the card.  Returns (wet
    [G, 2, n], new allpass windows, new line windows, new feedback
    state)."""
    if dtype != torch.float32:
        raise TypeError(f"reverb: the kernel runs float32, not {dtype}")
    kernels.require(drive_in, "reverb input", ndim=3)
    g, ch, n = drive_in.shape
    if ch != 2:
        raise ValueError(f"reverb input: {ch} channels, expected 2")
    dev = drive_in.device
    _operand(ap_delay, "reverb allpass delays", (g, 4), dev, torch.int64)
    _operand(line_delay, "reverb line delays", (g, 8), dev, torch.int64)
    _operand(blend, "reverb blend", (g, n), dev)
    _operand(regen, "reverb regen", (g, n), dev)
    _operand(vib_phase, "reverb vibrato phase", (g, 8, 2), dev)
    _operand(fb, "reverb feedback state", (g, 8, 2), dev)
    h_ap = _window(ap_buf, "reverb allpass windows", (g, 4, 2), dev)
    h_ln = _window(line_buf, "reverb line windows", (g, 8, 2), dev)
    if not 0 < g <= 32767 or n + 2 * max(h_ap, h_ln) >= 2 ** 31:
        raise ValueError(f"reverb: {g} lanes of {n} samples, windows of "
                         f"{h_ap} and {h_ln}")
    vib_inc = vib_increments(torch.float32, dev)
    wet = torch.empty_like(drive_in)
    new_ap = torch.empty_like(ap_buf)
    new_ln = torch.empty_like(line_buf)
    new_fb = torch.empty_like(fb)
    err = kernels.library().phonic_reverb(
        dev.index, drive_in.data_ptr(), ap_delay.data_ptr(),
        line_delay.data_ptr(), blend.data_ptr(), regen.data_ptr(),
        vib_phase.data_ptr(), vib_inc.data_ptr(), ap_buf.data_ptr(),
        line_buf.data_ptr(), fb.data_ptr(), wet.data_ptr(), new_ap.data_ptr(),
        new_ln.data_ptr(), new_fb.data_ptr(), g, n, h_ap, h_ln,
        kernels.stream_handle(drive_in))
    kernels.check(err, "reverb")
    tracing.count("kernel.reverb")
    return wet, new_ap, new_ln, new_fb


def network(drive_in, ap_delay, line_delay, blend, regen, vib_phase, ap_buf,
            line_buf, fb, b_ap: int, b_fdn: int, dtype=torch.float32):
    """One block of the delay network, ``(wet, ap_buf, line_buf, fb)``: the
    kernel for CUDA tensors, made contiguous first (the plain version's
    states may be views), the plain version for CPU ones."""
    if drive_in.is_cuda:
        return network_kernel(*(t.contiguous() for t in (
            drive_in, ap_delay, line_delay, blend, regen, vib_phase, ap_buf,
            line_buf, fb)), dtype)
    return network_plain(drive_in, ap_delay, line_delay, blend, regen,
                         vib_phase, ap_buf, line_buf, fb, b_ap, b_fdn, dtype)
