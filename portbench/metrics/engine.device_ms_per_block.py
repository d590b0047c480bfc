"""engine.device_ms_per_block (ms, device trace): the union of the
device's busy intervals per block of the traced window."""


def read(r):
    if r.trace is None or r.trace.busy_s <= 0:
        return None
    return 1e3 * r.trace.busy_s / r.trace.blocks
