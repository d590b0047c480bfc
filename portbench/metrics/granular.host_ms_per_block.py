"""granular.host_ms_per_block (ms, program span): host milliseconds per
block in the granular sampler's render, the ``granular.*`` spans
(``granular.notes``: each sample's note from the trigger slots and the
modulation matrix; ``granular.alloc``: the grain allocation's chunk loop;
``granular.mix``: the one read of every grain, the grain mix and the voice
AHDSR), per ``engine.step`` span of the traced run."""


def read(r):
    return r.module("metrics", "engine.host_ms_per_block").ms_per_block(
        lambda name: name.startswith("granular."))
