"""player.h2d_per_block (copies, device trace): host-to-device copies per
block of the traced window (the Player's design: one pinned buffer per
block)."""


def read(r):
    if r.trace is None or not r.trace.device_ops:
        return None
    return r.trace.h2d / r.trace.blocks
