"""generators.plan_events_per_block (events, program counter): note events
the generators' voice plans visit, the ``generator.plan_events`` counter
(every lane's summed), per ``engine.step`` span of the traced run.  A plan
that takes each event once reads the events scheduled per block; one that
replays the session grows with it."""


def read(r):
    spans = r.module("metrics", "engine.host_ms_per_block")
    got = spans.traced()
    if got is None:
        return None
    count = spans.registry().counters().get("generator.plan_events")
    return None if count is None else count / got[1]
