"""player.host_ms_per_block (ms, program span): host milliseconds per
block in the Player's pump, its ``player.dispatch`` and ``player.finish``
spans (the clock reads ``Player.cpu_load`` uses), per ``engine.step``
span of the traced run."""


def read(r):
    return r.module("metrics", "engine.host_ms_per_block").ms_per_block(
        lambda name: name in ("player.dispatch", "player.finish"))
