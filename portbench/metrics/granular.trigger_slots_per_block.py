"""granular.trigger_slots_per_block (slots, program counter): the trigger
slots the granular samplers lower, V voices times K slots (K the most
notes that start on one voice in the block, as a power of two), the
``granular.trigger_slots`` counter (every lane's summed), per
``engine.step`` span of the traced run.  The render's note logic works
over as many columns per voice."""


def read(r):
    spans = r.module("metrics", "engine.host_ms_per_block")
    got = spans.traced()
    if got is None:
        return None
    count = spans.registry().counters().get("granular.trigger_slots")
    return None if count is None else count / got[1]
