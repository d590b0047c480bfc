"""synth.trigger_slots_per_block (slots, program counter): the trigger slots
the synth generators lower, V voices times K slots (K the most notes that
start on one voice in the block, as a power of two), the
``synth.trigger_slots`` counter (every lane's summed), per ``engine.step``
span of the traced run.  The render's note logic works over as many
columns per voice."""


def read(r):
    spans = r.module("metrics", "engine.host_ms_per_block")
    got = spans.traced()
    if got is None:
        return None
    count = spans.registry().counters().get("synth.trigger_slots")
    return None if count is None else count / got[1]
