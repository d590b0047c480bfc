"""iir2_roofline (%, device trace): the least time of the traced blocks'
``iir2`` operations (``rooflines/iir2.py``) over the kernel-only time of
their launches."""

from harness.roofline import share


def read(r):
    return share(r, "iir2")
