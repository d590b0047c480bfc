"""generators.lower_ms_per_block (ms, program span): host milliseconds per
block in the generators' note lowering, the ``generator.*`` spans
(``generator.plan``: new events taken into the voice plan and placed;
``generator.lower``: the per-voice arrays), every lane's summed, per
``engine.step`` span of the traced run."""


def read(r):
    return r.module("metrics", "engine.host_ms_per_block").ms_per_block(
        lambda name: name.startswith("generator."))
