"""kernels.launches_per_block (launches, program counter): launches of the
hand-written kernels, the program's ``kernel.*`` counters, per
``engine.step`` span of the traced run."""


def read(r):
    spans = r.module("metrics", "engine.host_ms_per_block")
    got = spans.traced()
    if got is None:
        return None
    counts = spans.registry().counters()
    return sum(v for k, v in counts.items()
               if k.startswith("kernel.")) / got[1]
