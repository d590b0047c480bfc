"""granular.alloc_steps_per_block (steps, program counter): the grain
allocation's candidate steps the granular samplers issue, chunks times
candidates per chunk (each a handful of device operations over every
voice's pool), the ``granular.alloc_steps`` counter (every lane's in one
bank), per ``engine.step`` span of the traced run."""


def read(r):
    spans = r.module("metrics", "engine.host_ms_per_block")
    got = spans.traced()
    if got is None:
        return None
    count = spans.registry().counters().get("granular.alloc_steps")
    return None if count is None else count / got[1]
