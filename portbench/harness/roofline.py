"""A kernel's share of its roofline over the traced window.

The least time of one operation is the larger of its bytes over the
card's memory bandwidth and its float32 operations over the card's peak
(``peaks.json``), with the bytes and operations computed from the
operation's shapes by ``rooflines/<kernel>.py`` (inputs read once, outputs
written once), never from the launches: packing or splitting the work into
other launches leaves it the same.  The share is the least time of the
traced blocks' operations over the kernel-only time of the launches that
did them."""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def share(r, kernel: str):
    """Percent of the roofline, or None where the cell has no such
    operation or the card's peaks are unknown.  The work is the
    operations' least time per block times the traced blocks, whatever
    launches carry it; the time is the kernel-only time of every device
    kernel whose name holds the kernel file's ``NEEDLE``.  A cell whose
    configuration has the operation but whose trace holds no kernel of
    that name reads nothing, and says so on standard error (a renamed
    kernel, or one taken off the path)."""
    peaks = PEAKS.get(r.device_kind)
    ops = r.kernel_ops.get(kernel, [])
    if r.trace is None or peaks is None or not ops:
        return None
    mod = r.module("rooflines", kernel)
    launches, secs = r.trace.kernel(mod.NEEDLE)
    if launches == 0 or secs <= 0.0:
        r.notes.append(f"{kernel}_roofline: no device kernel named like "
                       f"{mod.NEEDLE!r} in the traced window; left out")
        return None
    least = 0.0
    for shape in ops:
        nbytes, flops = mod.cost(**shape)
        least += max(nbytes / peaks["hbm_bytes_per_s"],
                     flops / peaks["f32_flops_per_s"])
    r.notes.append(f"{kernel}_roofline: {launches} launches, "
                   f"{secs * 1e3:.4f} ms of kernel time, {least * 1e6:.3f} "
                   f"us of least time per block, {r.trace.blocks} blocks")
    return 100.0 * least * r.trace.blocks / secs
