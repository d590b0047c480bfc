"""synth.host_ms_per_block (ms, program span): host milliseconds per block
in the synth generator's render, the ``synth.*`` spans (``synth.notes``:
each sample's note chosen from the trigger slots; ``synth.voices``: the
modulation matrix and the SynthDef over every voice), per ``engine.step``
span of the traced run."""


def read(r):
    return r.module("metrics", "engine.host_ms_per_block").ms_per_block(
        lambda name: name.startswith("synth."))
