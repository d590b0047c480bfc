"""effects.host_ms_per_block (ms, program span): host milliseconds per
block in the effect chains, the ``effect.*`` spans (each stage of each
chain, its auto-bypass selects included), per ``engine.step`` span of the
traced run."""


def read(r):
    return r.module("metrics", "engine.host_ms_per_block").ms_per_block(
        lambda name: name.startswith("effect."))
