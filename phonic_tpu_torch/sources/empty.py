"""Silent placeholder source (reference: src/source/empty.rs, weight 0) and
null generator (reference: src/generator/empty.rs); port of
``phonic_tpu/sources/empty.py``.  Each renders as a lane bank of its own
(graph/batching.LeafBatch) whose output is zeros."""

from __future__ import annotations

import torch

from ..generators.base import Generator
from ..graph.nodes import BuildCtx, Source


def _silence(inputs, ctx: BuildCtx):
    lanes = inputs["_stop_at"].shape[0]
    return torch.zeros((lanes, ctx.channels, ctx.block_frames),
                       dtype=torch.float32, device=ctx.device)


class EmptySource(Source):
    WEIGHT = 0

    def duration_frames(self, ctx: BuildCtx):
        return 0

    def init_state(self, ctx: BuildCtx):
        return {}

    def render_lanes(self, state, params, inputs, live, frame0: int,
                     ctx: BuildCtx):
        return state, _silence(inputs, ctx)


class EmptyGenerator(Generator):
    WEIGHT = 0

    def lower_block_inputs(self, block_start, block_len):
        return None

    def duration_frames(self, ctx: BuildCtx):
        return 0

    def init_state(self, ctx: BuildCtx):
        return {}

    def render_lanes(self, state, params, inputs, live, frame0: int,
                     ctx: BuildCtx):
        return state, _silence(inputs, ctx)
