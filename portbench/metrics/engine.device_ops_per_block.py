"""engine.device_ops_per_block (ops, device trace): device operations
(kernels, copies, sets) per block of the traced window: what the engine
step's host loop launches."""


def read(r):
    if r.trace is None or not r.trace.device_ops:
        return None
    return r.trace.device_ops / r.trace.blocks
