"""Block-feedback decomposition (port of ``pick_subblock`` from
``phonic_tpu/ops/ring.py``).

A feedback delay's written sample depends on earlier outputs, which is
sequential, but the dependency latency equals the delay length D: writes
inside a span of B <= D-1 samples never feed their own reads.  So a block
processes as a loop over sub-blocks of B samples, each fully vectorised.
"""

from __future__ import annotations


def pick_subblock(min_delay_samples: float, block_frames: int,
                  cap: int = 2048) -> int:
    """Largest power-of-two sub-block B with B + 1 <= min delay, dividing
    block_frames; at least 1."""
    b = 1
    while (
        b * 2 + 1 <= int(min_delay_samples)
        and b * 2 <= cap
        and block_frames % (b * 2) == 0
    ):
        b *= 2
    return b
