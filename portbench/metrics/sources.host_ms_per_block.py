"""sources.host_ms_per_block (ms, program span): host milliseconds per
block in the engine's source banks, the ``source.*`` spans (each file
bank's and each generator pool's render), per ``engine.step`` span of the
traced run."""


def read(r):
    return r.module("metrics", "engine.host_ms_per_block").ms_per_block(
        lambda name: name.startswith("source."))
