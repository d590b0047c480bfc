"""player.wait_ms_per_block (ms, program span): host milliseconds per
block that the Player's finish waits for a block's copies to reach the
host, the ``player.wait`` spans, per ``engine.step`` span of the traced
run."""


def read(r):
    return r.module("metrics", "engine.host_ms_per_block").ms_per_block(
        lambda name: name == "player.wait")
