"""engine.host_ms_per_block (ms, program span): host milliseconds per
block inside the engine's block step: the ``engine.step`` spans that the
program's ``phonic_tpu_torch.tracing`` recorded while the traced run's
profiler recorded (its lead-in and its window), over their number.  Also
notes the stage table: each span name's self time (its duration less its
children's) and calls, per block.

The helpers below serve every metric of the program's spans and counters,
each per ``engine.step`` span; they give None where the program recorded
none (a program without ``tracing``)."""


def registry():
    """The program's span registry, or None."""
    try:
        from phonic_tpu_torch import tracing
    except ImportError:
        return None
    return tracing


def traced():
    """(every recorded span, the number of ``engine.step`` spans), or None
    where no step was recorded."""
    tracing = registry()
    if tracing is None:
        return None
    spans = tracing.spans()
    steps = sum(s.name == "engine.step" and s.end is not None for s in spans)
    return (spans, steps) if steps else None


def ms_per_block(match):
    """Host milliseconds per block in the closed spans whose name
    ``match`` accepts, or None where there are none."""
    got = traced()
    if got is None:
        return None
    spans, steps = got
    ns = [s.end - s.start for s in spans if s.end is not None
          and match(s.name)]
    return sum(ns) / 1e6 / steps if ns else None


def stage_table(spans, steps, counts) -> str:
    """One line: each span name's self milliseconds and calls per block,
    the largest self time first, then each counter per block."""
    own = [0 if s.end is None else s.end - s.start for s in spans]
    for s, d in zip(spans, list(own)):
        if s.parent >= 0:
            own[s.parent] -= d
    self_ns, calls = {}, {}
    for s, d in zip(spans, own):
        self_ns[s.name] = self_ns.get(s.name, 0) + d
        calls[s.name] = calls.get(s.name, 0) + 1
    rows = sorted(self_ns, key=lambda k: -self_ns[k])
    return (f"stages over {steps} blocks (self ms per block x calls per "
            "block): " + ", ".join(
                f"{k} {self_ns[k] / 1e6 / steps:.4f} x{calls[k] / steps:g}"
                for k in rows) + "; counters per block: " + ", ".join(
                f"{k} {v / steps:g}" for k, v in sorted(counts.items())))


def read(r):
    got = traced()
    if got is None:
        return None
    r.notes.append(stage_table(*got, registry().counters()))
    return ms_per_block(lambda name: name == "engine.step")
