"""ramp_read_roofline (%, device trace): the least time of the traced
blocks' ``ramp_read`` operations (``rooflines/ramp_read.py``) over the
kernel-only time of their launches."""

from harness.roofline import share


def read(r):
    return share(r, "ramp_read")
