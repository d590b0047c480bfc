"""lanes.lower_ms_per_block (ms, program span): host milliseconds per
block in the benchmark's span around every lane program's public
``block_inputs``, over every block the run lowered."""


def read(r):
    if not r.lower_s or not r.lowered_blocks:
        return None
    return 1e3 * r.lower_s / r.lowered_blocks
