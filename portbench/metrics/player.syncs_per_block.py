"""player.syncs_per_block (calls, device trace): ``cudaStreamSynchronize``
calls per block of the traced window (the pump finishes on an event)."""


def read(r):
    if r.trace is None or not r.trace.device_ops:
        return None
    return r.trace.syncs / r.trace.blocks
