"""Mixer graph topology (host-side description).

Carried over unchanged from ``phonic_tpu/graph/mixer.py`` (it holds no
tensors).  Behavioural spec: reference src/source/mixed.rs — a mixer node
sums playing sources and child mixers, then runs an ordered effect chain.
The reference parallelises sub-mixers over an RT thread pool
(src/source/mixed/submixer/thread_pool.rs); here sibling sub-mixers with
identical effect chains run as one batched chain (graph/engine.py), so
sub-mixer "parallelism" is a leading lane dimension.
"""

from __future__ import annotations

import itertools
from typing import Optional

from .nodes import Effect, Source

_counter = itertools.count()


class Mixer:
    def __init__(self, name: Optional[str] = None):
        self.name = name or f"mixer_{next(_counter)}"
        self.sources: list[Source] = []
        self.effects: list[Effect] = []
        self.children: list["Mixer"] = []

    def add_source(self, source: Source) -> Source:
        self.sources.append(source)
        return source

    def add_effect(self, effect: Effect, index: Optional[int] = None) -> Effect:
        """Ordered insert (reference: MixerMessage::AddEffect/MoveEffect)."""
        if index is None:
            self.effects.append(effect)
        else:
            self.effects.insert(index, effect)
        return effect

    def move_effect(self, effect: Effect, new_index: int):
        self.effects.remove(effect)
        self.effects.insert(new_index, effect)

    def remove_effect(self, effect: Effect):
        self.effects.remove(effect)

    def remove_source(self, source: Source):
        """Detach a source (reference: MixerMessage::RemoveSource,
        src/source/mixed.rs:47-194)."""
        self.sources.remove(source)

    def add_mixer(self, mixer: Optional["Mixer"] = None) -> "Mixer":
        mixer = mixer or Mixer()
        self.children.append(mixer)
        return mixer

    def remove_mixer(self, mixer: "Mixer"):
        """Detach a child mixer and its whole subtree (reference:
        MixerMessage::RemoveMixer, src/source/mixed.rs:47-194)."""
        self.children.remove(mixer)

    def find_parent_of(self, obj) -> Optional["Mixer"]:
        """The mixer that directly owns ``obj`` (source/effect/child mixer),
        searching the whole subtree; None if not found."""
        if obj in self.sources or obj in self.effects or obj in self.children:
            return self
        for c in self.children:
            p = c.find_parent_of(obj)
            if p is not None:
                return p
        return None

    def walk(self, prefix: str = ""):
        """Yield (path, kind, obj) for every node in the tree, depth-first;
        paths are stable compile keys."""
        me = f"{prefix}{self.name}"
        yield me, "mixer", self
        for s in self.sources:
            yield f"{me}/{s.name}", "source", s
        for e in self.effects:
            yield f"{me}/{e.name}", "effect", e
        for c in self.children:
            yield from c.walk(f"{me}/")

    def total_weight(self) -> int:
        """Cost hint sum (reference: src/source/mixed.rs:734-748)."""
        w = sum(s.WEIGHT for s in self.sources) + sum(e.WEIGHT for e in self.effects)
        return w + sum(c.total_weight() for c in self.children)
