"""block_ms.p95 (ms, host clock): the 95th percentile, over every block of
the measured window, of the wall interval between consecutive deliveries of
a block to the output device (the first counted from the window's start):
the wait a realtime consumer sees."""

import numpy as np


def read(r):
    times = np.asarray([r.t0] + list(r.arrivals[r.first:]))
    if len(times) < 2:
        return None
    return float(np.percentile(np.diff(times) * 1e3, 95))
