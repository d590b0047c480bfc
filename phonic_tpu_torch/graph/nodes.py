"""Render-graph node protocol (port of ``phonic_tpu/graph/nodes.py``).

Every node is static Python config plus a function over tensors; the
engine (graph/engine.py) walks the graph once per block.

Node contract:
  * ``PARAMS``: tuple of parameter descriptors (params.py).  The engine owns
    one timeline + smoother per (node, param) and hands ``process`` a dict
    of denormalized, smoothed, per-sample value tensors — the engine-level
    analog of the reference's SmoothedParameterValue
    (src/parameter/smoothed.rs).
  * ``init_state(ctx)``: one instance's state, a dict of tensors (or of
    NamedTuples of tensors).  The engine stacks the states of the G lanes
    that run together along a new leading dimension; a lone effect is
    G = 1.
  * Effects: ``process(state, x, params, ctx)`` maps ``x`` [G, ch, n] with
    params [G, n] and the stacked state to ``(new_state, y)``.
"""

from __future__ import annotations

import itertools
from typing import NamedTuple, Optional

import torch

from ..params import Parameter


class BuildCtx(NamedTuple):
    sample_rate: int
    channels: int
    block_frames: int
    max_events: int
    # dtype for recursive filter/feedback state (EngineConfig.scan_dtype)
    scan_dtype: torch.dtype = torch.float32
    device: torch.device = torch.device("cpu")


_counter = itertools.count()


class Node:
    PARAMS: tuple[Parameter, ...] = ()
    # relative CPU cost hint 1..10 (reference: src/source.rs:100-103)
    WEIGHT: int = 1

    def __init__(self, name: Optional[str] = None):
        self.name = name or f"{type(self).__name__.lower()}_{next(_counter)}"

    def param(self, pid: str) -> Parameter:
        for p in self.PARAMS:
            if p.id == pid:
                return p
        raise KeyError(f"{self.name}: unknown parameter {pid!r}")

    def param_initials(self) -> dict:
        """Initial raw values per parameter; override to reflect constructor
        options."""
        return {p.id: p.default for p in self.PARAMS}

    def prepare(self, ctx: BuildCtx) -> None:
        """Called once by RenderProgram at construction, before any state
        init or host lowering: receive the build context (sample rate,
        block size) here.  Lowering hooks never fall back to a default
        rate."""
        return None

    def handle_message(self, message, time: int = 0) -> None:
        """Host-side message hook (reference: Effect::process_message, e.g.
        the reverb's reset).  Default: ignore."""
        return None

    def lower_block_inputs(self, block_start: int, block_len: int):
        """Host lowering hook: a dict of extra per-block numpy values that
        ``process`` receives in its params dict (keys start with '_')."""
        return None


class Effect(Node):
    """Audio in -> audio out (reference: src/effect.rs:86-215).
    ``tail_frames`` is the ring-out length an offline render appends
    (reference: src/effect.rs:190-215)."""

    def batch_key(self, ctx: BuildCtx):
        """Hashable key for cross-mixer effect batching, or None if this
        effect cannot run batched with others.  Two effects with equal keys
        must run the same code in ``process`` (the key covers every static
        attribute ``process`` reads; runtime parameters may differ per
        lane)."""
        return None

    def init_state(self, ctx: BuildCtx):
        return {}

    def process(self, state, x, params, ctx: BuildCtx):
        raise NotImplementedError

    def tail_frames(self, ctx: BuildCtx) -> int:
        return 0

    def max_tail_frames(self, ctx: BuildCtx) -> int:
        """Worst-case tail over the full automatable parameter ranges."""
        return self.tail_frames(ctx)


class Source(Node):
    """Produces audio (reference: src/source.rs:80-110).
    ``duration_frames`` is the number of frames the source produces at the
    output rate, or None if it is endless (looped, or a generator)."""

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        return None
