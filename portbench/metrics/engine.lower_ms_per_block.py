"""engine.lower_ms_per_block (ms, program span): host milliseconds per
block in the program's lowering of a block's events, the ``engine.lower``
spans of ``RenderProgram.block_inputs`` (every lane's, summed), per
``engine.step`` span of the traced run."""


def read(r):
    return r.module("metrics", "engine.host_ms_per_block").ms_per_block(
        lambda name: name == "engine.lower")
