"""Graph walker + block render engine (port of
``phonic_tpu/graph/engine.py``).

The host holds the graph topology and event timelines; ``RenderProgram``
renders one block at a time,

    step(state, block_inputs) -> (state, audio[channels, block])

walking the graph in PyTorch on the program's device: every file-source
group as one lane bank, every group of samplers as one generator pool,
every effect chain with a leading lane dimension
(sibling mixers with identical chains share one batched chain), and every
parameter group's smoother as one batched computation.  Sample-accurate
automation arrives as fixed-shape segment events per (node, parameter) per
block (events.py), applied by the closed-form smoothers in
ops/smoothing.py.

The JAX package compiles the step into one program and can scan it over
blocks on the device; here ``render`` is a host loop over blocks and
nothing is compiled, so the JAX package's recompile guard
(``jit_cache_size``) has no counterpart.

A program built with ``lanes=L`` renders L independent instances of the
graph in every step, ``audio[L, channels, block]`` (the lane-batched
programs of ``parallel/mesh.py``).  The lanes fold into the leading
dimension of every bank: a file bank of S sources reads L*S rows, a pool
of G nodes holds L*G, a chain of G mixers runs L*G, each lane-major (row
``l * G + i`` is member i of instance l).  A block's inputs are either
shared by the lanes or given per lane:

* shared (one dict of :meth:`RenderProgram.block_inputs`): a block lowers
  and uploads one instance's inputs, smooths each parameter once, and each
  bank gathers its parameter rows for all lanes in the same
  ``index_select``;
* per lane (a sequence of L such dicts, lane k's lowered by a program of a
  structurally equal graph with its own schedule): the parameter groups
  lower into ``[L*P, K]`` event rows, the smoothers carry ``[L*P]`` rows
  from the first such block on (a shared block after it tiles its events
  over the lanes on the device), and each bank reads lane l's rows
  ``l * P + r``; stops, seeks, note arrays and effect inputs come from
  each lane's dict.  The lanes' blocks may start at different frames: a
  block whose lanes' ``frame0`` differ gives every bank its rows' start
  frames as a device tensor (``b{i}.f0`` / ``q{i}.f0``); otherwise the
  banks take the one ``frame0`` as a host int.  No host decision reads
  ``frame0``.

Either way a block makes the launches of one instance, each over L times
the rows.

Every block reaches the device through :meth:`RenderProgram.pack_inputs`:
the host arrays it needs travel in one buffer (pinned on a CUDA program),
one asynchronous copy per block, and the step reads views of it, so nothing
in the step waits for the stream.  ``step`` is ``step_packed`` over
``pack_inputs``; the Player packs a block ahead of its step.

The walk calls each bank through one interface: a file bank's ``render``,
a pool's ``voices`` and ``render``, and a chain's ``run`` (:func:`run_stages`
over its effects).  ``parallel/mesh.GraphShardedProgram`` splits banks over
several devices by stepping a copy of the program whose split banks and
chains stand behind that same interface.
"""

from __future__ import annotations

import bisect
import functools
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from .. import tracing
from ..config import DEFAULT_CONFIG, DEFAULT_INERTIA, EngineConfig, resolve_device
from ..errors import NotFoundError
from ..events import ParamTimeline
from ..generators.sampler import Sampler
from ..generators.synth import SynthGenerator
from ..ops import smoothing
from ..sources.empty import EmptyGenerator, EmptySource
from ..sources.file import NEVER, FileSource
from ..sources.streamed import StreamedFileSource
from ..sources.synth import SynthSource
from .batching import (FileBatch, LeafBatch, group_key as _file_group_key,
                       stack_states)
from .mixer import Mixer
from .nodes import BuildCtx, Node


class _FrozenMixer:
    """Immutable snapshot of a Mixer's structure (shared node objects, fixed
    lists): what a program walks."""

    __slots__ = ("name", "sources", "effects", "children")

    def __init__(self, name, sources, effects, children):
        self.name = name
        self.sources = sources
        self.effects = effects
        self.children = children

    def walk(self, prefix: str = ""):
        me = f"{prefix}{self.name}"
        yield me, "mixer", self
        for s in self.sources:
            yield f"{me}/{s.name}", "source", s
        for e in self.effects:
            yield f"{me}/{e.name}", "effect", e
        for c in self.children:
            yield from c.walk(f"{me}/")


# the source and generator types a program renders: file sources as
# FileBatch lanes, every other type as lanes of a LeafBatch
SOURCE_TYPES = (FileSource, Sampler, SynthSource, SynthGenerator,
                StreamedFileSource, EmptySource, EmptyGenerator)


def bank_inputs(node, lowered, stop: int, kill: int) -> dict:
    """A leaf node's block inputs in its LeafBatch: what it lowered, and,
    for every node but a sampler (which ignores them, as in the JAX
    package), its stop and kill frames."""
    out = dict(lowered or {})
    if not isinstance(node, Sampler):
        out["_stop_at"] = np.int32(min(stop, NEVER))
        out["_kill_at"] = np.int32(min(kill, NEVER))
    return out


def _freeze_mixer(m: Mixer) -> _FrozenMixer:
    return _FrozenMixer(m.name, tuple(m.sources), tuple(m.effects),
                        tuple(_freeze_mixer(c) for c in m.children))


# silence age a fresh program's effects start at: bypassed until audio
# arrives (reference: EffectProcessor starts stopped, effect.rs:94-107)
AGE_MAX = 1 << 30
# an effect's input counts as silent at or below -60 dB
# (reference: src/source/mixed/effect.rs:10-153)
SILENCE = 1e-3


def tree_map(fn, *trees):
    """``fn`` over the leaves (tensors) of equally shaped state trees:
    dicts, lists and tuples (NamedTuples included)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    if isinstance(t0, tuple):
        out = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t0)(*out) if hasattr(t0, "_fields") else tuple(out)
    return fn(*trees)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_layout(tree):
    """The tree's structure with each leaf's shape and dtype: equal layouts
    hold equally shaped states."""
    if isinstance(tree, dict):
        return ("dict", tuple((k, tree_layout(v)) for k, v in tree.items()))
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__, tuple(tree_layout(v) for v in tree))
    return (tuple(tree.shape), str(tree.dtype))


def _carry_rows(new, old, pairs):
    """``new`` with row ``i`` replaced by ``old``'s row ``j`` for each
    ``(i, j)`` of ``pairs``, on the leading dimension of every leaf, out of
    place (a fresh state may share a tensor between two fields); rows whose
    layouts differ are left as they are."""
    pairs = [(i, j) for i, j in pairs
             if tree_layout(tree_map(lambda a: a[i], new))
             == tree_layout(tree_map(lambda a: a[j], old))]
    if not pairs:
        return new
    dev = tree_leaves(new)[0].device
    ni = torch.tensor([i for i, _ in pairs], dtype=torch.int64, device=dev)
    oi = torch.tensor([j for _, j in pairs], dtype=torch.int64, device=dev)
    return tree_map(lambda a, b: a.index_copy(0, ni, b.index_select(0, oi)),
                    new, old)


# numpy dtype (``dtype.str``) -> torch dtype, for views of a packed buffer
_TORCH = {np.dtype(t).str: getattr(torch, t) for t in
          ("float32", "float64", "int32", "int64", "bool")}


class PackedInputs(NamedTuple):
    """One block's inputs for :meth:`RenderProgram.step_packed`."""

    inputs: dict  # the block's host inputs (numpy), for what the host reads
    host: dict  # host values derived from them: segment counts, pool layouts
    device: dict  # name -> device view of the block's one packed buffer


class MixerLevels(dict):
    """mixer path -> (peak [ch], rms [ch]), post-effects, as views of
    ``stats`` ([2, mixers, ch]: peaks, then RMS), so one copy fetches every
    mixer's levels."""

    def __init__(self, paths, stats: torch.Tensor):
        super().__init__((p, (stats[0, i], stats[1, i]))
                         for i, p in enumerate(paths))
        self.stats = stats


def run_stages(effects, limits, ctx, x, states, age0, stage_params):
    """A chain's effects (``effects``: one lane's, each run batched over the
    chain's rows) over x [R, ch, n] from their ``states``; stage i's
    parameters are ``stage_params(i)``.  Returns (states, silence ages or
    None, output).  A program's chain runs it as ``chain["run"](x, states,
    age0, stage_params)``.

    Under auto-bypass (``age0`` [stages, R] and ``limits`` given) each
    (stage, row) keeps a silence age: a stage whose input is silent and has
    been for longer than its limit passes its input through and keeps its
    state.  The stage still runs and selects per row (``torch.where``), so
    no branch reads a device value on the host; for one lane this is the
    JAX package's per-effect ``lax.cond``, for several its
    ``run_chain_frozen``."""
    n = ctx.block_frames
    sts, ages = [], []
    for i, e0 in enumerate(effects):
        with tracing.span(e0.SPAN):
            pvals = stage_params(i)
            st0 = states[i]
            if age0 is not None:
                silent = torch.amax(torch.abs(x), dim=(1, 2)) <= SILENCE
                skip = silent & (age0[i] >= limits[i])
                st, y = e0.process(st0, x, pvals, ctx)
                x = torch.where(skip[:, None, None], x, y)
                st = tree_map(lambda a, b: torch.where(
                    skip.view((-1,) + (1,) * (a.dim() - 1)), a, b),
                    st0, st)
                ages.append(torch.where(silent, age0[i] + n, 0))
            else:
                st, x = e0.process(st0, x, pvals, ctx)
        sts.append(st)
    if age0 is None:
        return sts, None, x
    return sts, torch.clamp(torch.stack(ages), max=AGE_MAX), x


class RenderProgram:
    """A render program for one graph topology on one device."""

    def __init__(self, root: Mixer, config: EngineConfig = DEFAULT_CONFIG,
                 device: Optional[Union[str, torch.device]] = None,
                 lanes: Optional[int] = None):
        """``lanes``: None renders one instance of the graph, ``audio[ch,
        n]``; an int renders that many independent instances folded into
        every bank, ``audio[lanes, ch, n]``."""
        if lanes is not None and lanes < 1:
            raise ValueError(f"lanes must be >= 1, got {lanes}")
        self.lanes = lanes or 1
        self._lane_axis = lanes is not None
        self.root = root
        # freeze the topology now: a program never sees nodes it didn't index
        self._frozen = _freeze_mixer(root)
        self.config = config
        self.device = resolve_device(config.device if device is None else device)
        self.ctx = BuildCtx(
            sample_rate=config.sample_rate,
            channels=config.channels,
            block_frames=config.block_frames,
            max_events=config.max_events_per_block,
            scan_dtype=config.scan_dtype,
            device=self.device,
        )
        self._index_nodes()
        for node in self.nodes.values():
            node.prepare(self.ctx)
        # automation timelines per (path, param)
        self.timelines: dict[tuple[str, str], ParamTimeline] = {}
        for path, node in self.nodes.items():
            initials = node.param_initials()
            for p in node.PARAMS:
                self.timelines[(path, p.id)] = ParamTimeline(
                    initial=float(initials.get(p.id, p.default)))
        # each node sees its own timelines (file sources size their speed
        # bound from the scheduled speeds)
        for path, node in self.nodes.items():
            node._timelines = {p.id: self.timelines[(path, p.id)]
                               for p in node.PARAMS}
        self._build_param_groups()
        self._build_source_batches()
        self._build_effect_batches()
        # scheduled stop/kill frames per source path (NEVER = none)
        self.stop_frames: dict[str, int] = {p: NEVER for p in self.source_paths}
        self.kill_frames: dict[str, int] = {p: NEVER for p in self.source_paths}
        # the packed-input layout of the last block (step_packed): a
        # change of its arrays' names, shapes or dtypes makes a new one
        self._pack_spec = None
        self._pack_version = 0

    # ------------------------------------------------------------------
    # graph indexing
    # ------------------------------------------------------------------

    def _index_nodes(self):
        self.nodes: dict[str, Node] = {}
        self.source_paths: list[str] = []
        self.path_of: dict[int, str] = {}
        for path, kind, obj in self._frozen.walk():
            if kind == "mixer":
                continue
            if path in self.nodes:
                raise ValueError(f"duplicate node path {path}")
            if kind == "source" and type(obj) not in SOURCE_TYPES:
                raise NotImplementedError(
                    f"{type(obj).__name__} sources have no renderer in "
                    "this package")
            self.nodes[path] = obj
            self.path_of[id(obj)] = path
            if kind == "source":
                self.source_paths.append(path)

    def _build_param_groups(self):
        """Group every (node, parameter) by smoother kind + coefficient so a
        whole graph's smoothing runs as a handful of batched computations."""
        groups: dict[tuple, list] = {}
        for path, node in self.nodes.items():
            for p in node.PARAMS:
                kind = getattr(p, "smoothing", None)
                arg = getattr(p, "smoothing_arg", None)
                if kind == "exponential":
                    key = ("exponential", float(arg or DEFAULT_INERTIA))
                elif kind == "linear":
                    key = ("linear", float(arg or 0.01))
                elif kind == "spring":
                    key = ("spring", float(arg or 4410.0))
                else:
                    key = ("step", 0.0)
                groups.setdefault(key, []).append((path, p.id))
        self._param_groups = groups
        self._param_row = {
            pp: (key, i) for key, pps in groups.items() for i, pp in enumerate(pps)
        }

    def _rows(self, paths, pid):
        """(group key, shared rows, per-lane rows): row-index tensors
        selecting parameter ``pid`` of each node path for every lane (all
        rows of one parameter share a smoother group).  Shared rows index a
        group's ``[P, n]`` values, the same rows for every instance;
        per-lane rows index its ``[L*P, n]`` values, lane l's at
        ``l * P + r``."""
        keys = {self._param_row[(p, pid)][0] for p in paths}
        if len(keys) != 1:
            raise ValueError(f"{pid}: lanes smooth differently ({keys})")
        key = keys.pop()
        rows = [self._param_row[(p, pid)][1] for p in paths]
        size = len(self._param_groups[key])

        def index(r):
            return torch.tensor(r, dtype=torch.int64, device=self.device)
        return key, index(rows * self.lanes), index(
            [lane * size + r for lane in range(self.lanes) for r in rows])

    def _build_source_batches(self):
        """Every file source renders as a lane of a FileBatch: one bank per
        group of homogeneous sources; every other source as a lane of a
        LeafBatch (a sampler's generator pool, a bank of synth or streamed
        sources): one per ``source_batch_key``, where a key of None (a
        granular sampler's, a synth generator's, an empty node's) makes a
        bank of its own.  With ``batch_sources`` off, each source is a bank
        of its own."""
        groups: dict[tuple, list[str]] = {}
        pools: dict[tuple, list[str]] = {}
        batch = self.config.batch_sources
        for i, path in enumerate(self.source_paths):
            node = self.nodes[path]
            if type(node) is FileSource:
                key = _file_group_key(node) if batch else i
                groups.setdefault(key, []).append(path)
            else:
                key = (getattr(node, "source_batch_key", lambda c: None)(
                    self.ctx) if batch else None)
                pools.setdefault(("alone", i) if key is None
                                 else (type(node).__name__,) + key,
                                 []).append(path)
        self.file_batches: list[FileBatch] = []
        self._batch_rows: list[dict] = []
        # source path -> (bank or pool index, lane)
        self._bank_lane: dict[str, tuple[int, int]] = {}
        self._pool_lane: dict[str, tuple[int, int]] = {}
        for paths in groups.values():
            self._bank_lane.update((p, (len(self.file_batches), i))
                                   for i, p in enumerate(paths))
            self.file_batches.append(
                FileBatch([self.nodes[p] for p in paths], paths, self.ctx,
                          self.lanes))
            self._batch_rows.append(
                {pid: self._rows(paths, pid) for pid in ("VOLU", "PANN", "SPED")})
        self.pools: list[LeafBatch] = []
        self._pool_rows: list[dict] = []
        for paths in pools.values():
            self._pool_lane.update((p, (len(self.pools), i))
                                   for i, p in enumerate(paths))
            pool = LeafBatch([self.nodes[p] for p in paths], paths, self.ctx,
                             self.lanes)
            self.pools.append(pool)
            self._pool_rows.append(
                {p.id: self._rows(paths, p.id) for p in pool.proto.PARAMS})

    def _build_effect_batches(self):
        """Collect effect chains.  Sibling mixers whose chains have
        identical batch-key signatures form one chain with G lanes (the
        analog of the reference's sub-mixer thread pool,
        src/source/mixed/submixer/thread_pool.rs:278-334); every other
        mixer with effects is a chain of one lane.

        ``self.chains[cid]`` holds the lane mixers, their paths and effect
        lists, under auto-bypass each (stage, lane)'s silence limit
        ([stages, L*G]), and its runner ``run`` (:func:`run_stages`);
        ``self._chain_of`` maps a mixer path to its chain and
        ``self._eff_loc`` an effect path to its (chain, stage, lane)."""
        self.chains: list[dict] = []
        self._chain_of: dict[str, int] = {}
        self._eff_loc: dict[str, tuple[int, int, int]] = {}

        def add_chain(mixers, paths):
            cid = len(self.chains)
            effects = [list(m.effects) for m in mixers]
            epaths = [[f"{p}/{e.name}" for e in m.effects]
                      for p, m in zip(paths, mixers)]
            params = []
            for i, e0 in enumerate(effects[0]):
                lane_paths = [eps[i] for eps in epaths]
                params.append({p.id: self._rows(lane_paths, p.id)
                               for p in e0.PARAMS})
            chain = {"mixers": list(mixers), "mixer_paths": paths,
                     "effects": effects, "effect_paths": epaths,
                     "params": params}
            if self.config.auto_bypass:
                # worst-case tail over the parameter ranges plus 2 s: runtime
                # automation can lengthen a tail past the construction-time
                # estimate, and a bypass must never freeze a ringing tail
                sr = self.ctx.sample_rate
                chain["limits"] = torch.tensor(
                    [[effs[i].max_tail_frames(self.ctx) + 2 * sr
                      for effs in effects] * self.lanes
                     for i in range(len(effects[0]))],
                    dtype=torch.int32, device=self.device)
            chain["run"] = functools.partial(run_stages, effects[0],
                                             chain.get("limits"), self.ctx)
            self.chains.append(chain)
            for p in paths:
                self._chain_of[p] = cid
            for lane, eps in enumerate(epaths):
                for i, ep in enumerate(eps):
                    self._eff_loc[ep] = (cid, i, lane)

        def visit(m: _FrozenMixer, me: str):
            if m.effects and me not in self._chain_of:
                add_chain([m], [me])
            groups: dict[tuple, list[_FrozenMixer]] = {}
            if self.config.batch_effects:
                for c in m.children:
                    if not c.effects:
                        continue
                    sig = tuple(e.batch_key(self.ctx) for e in c.effects)
                    if all(k is not None for k in sig):
                        groups.setdefault(sig, []).append(c)
            for cs in groups.values():
                if len(cs) >= 2:
                    add_chain(cs, [f"{me}/{c.name}" for c in cs])
            for c in m.children:
                visit(c, f"{me}/{c.name}")

        visit(self._frozen, self._frozen.name)

    # ------------------------------------------------------------------
    # control plane
    # ------------------------------------------------------------------

    def _resolve(self, node: Union[str, Node]) -> str:
        if isinstance(node, str):
            if node not in self.nodes:
                raise NotFoundError(f"no node at path {node!r}")
            return node
        path = self.path_of.get(id(node))
        if path is None:
            raise NotFoundError(f"node {getattr(node, 'name', node)!r} not in graph")
        return path

    def set_parameter(self, node, pid: str, value, at_frame: int = 0):
        """Schedule a parameter target change at an absolute output frame
        (reference: sample-time-tagged ProcessEffectParameterUpdate,
        src/source/mixed.rs:47-194)."""
        path = self._resolve(node)
        raw = self.nodes[path].param(pid).clamp(value)
        self.timelines[(path, pid)].set_at(at_frame, float(raw))

    def set_parameter_normalized(self, node, pid: str, normalized: float,
                                 at_frame: int = 0):
        """Parameter update by normalized 0..1 position through the
        descriptor's scaling (reference: ParameterValueUpdate::Normalized,
        src/parameter.rs:106-113)."""
        path = self._resolve(node)
        raw = self.nodes[path].param(pid).denormalize(float(normalized))
        self.timelines[(path, pid)].set_at(at_frame, float(raw))

    def remove_pending_events(self, node=None, after_frame: int = 0):
        """Drop all scheduled parameter events at/after ``after_frame``: for
        one node, or for the whole graph plus pending stop/kill schedules
        (reference: MixerMessage::RemoveAllPendingEvents,
        src/source/mixed.rs:47-194)."""
        only = None if node is None else self._resolve(node)
        for (path, _), tl in self.timelines.items():
            if only is not None and path != only:
                continue
            cut = bisect.bisect_left(tl.times, int(after_frame))
            del tl.times[cut:], tl.values[cut:], tl.ramps[cut:]
        if node is None:
            for p in self.source_paths:
                if self.stop_frames[p] >= after_frame:
                    self.stop_frames[p] = NEVER
                if self.kill_frames[p] >= after_frame:
                    self.kill_frames[p] = NEVER

    def set_parameter_glide(self, node, pid: str, value, rate: float,
                            at_frame: int = 0):
        """Like set_parameter but ramping at ``rate`` semitones/second
        (reference: FilePlaybackHandle::set_speed's glide argument,
        src/player/handles/file.rs:150-176)."""
        path = self._resolve(node)
        raw = self.nodes[path].param(pid).clamp(value)
        self.timelines[(path, pid)].set_glide_at(
            at_frame, float(raw), float(rate), self.ctx.sample_rate)

    def stop_source(self, source, at_frame: int = 0, kill: bool = False):
        """Schedule a stop (with the source's fade-out) or kill (hard cut)."""
        path = self._resolve(source)
        if path not in self.stop_frames:
            raise NotFoundError(f"{path} is not a source")
        frames = self.kill_frames if kill else self.stop_frames
        frames[path] = min(frames[path], int(at_frame))

    def adopt(self, old: "RenderProgram", old_state):
        """Carry control and running state across a topology rebuild (live
        add / remove of sources, effects and mixers: the reference keeps
        unrelated sources playing through such edits, src/player.rs
        add_source / add_effect).  Everything present in both programs
        carries by path: timelines, stop / kill frames, file-bank lane
        positions, pool voice state, each chain lane's effect state and
        smoother rows.  A silence age carries where the effect's input is
        the same: its mixer's chain up to it holds the same effects;
        every other age resets to 0 (recently active), so a rebuild never
        freezes a still-ringing tail.  Returns the new state."""
        if self.lanes != 1 or old.lanes != 1:
            raise NotImplementedError(
                "adopt carries the state of single-instance programs; a "
                "lane-batched program starts from init_state")
        for key, tl in old.timelines.items():
            if key in self.timelines:
                self.timelines[key] = tl
        for path, node in self.nodes.items():
            node._timelines = {p.id: self.timelines[(path, p.id)]
                               for p in node.PARAMS}
        for path in self.source_paths:
            if path in old.stop_frames:
                self.stop_frames[path] = old.stop_frames[path]
                self.kill_frames[path] = old.kill_frames[path]
        new = self.init_state()

        def carry(new_groups, old_groups, paths_of, old_loc, keys=None):
            """Each group's lanes from wherever their path lived in the old
            program (``old_loc``: path -> (old group, old lane)); with
            ``keys(g)``, only those top-level keys of group g's state."""
            out = []
            for g, st in enumerate(new_groups):
                by_old: dict = {}
                for lane, path in enumerate(paths_of(g)):
                    loc = old_loc.get(path)
                    if loc is not None:
                        by_old.setdefault(loc[0], []).append((lane, loc[1]))
                ks = None if keys is None else keys(g)
                for og, pairs in by_old.items():
                    if ks is None:
                        st = _carry_rows(st, old_groups[og], pairs)
                        continue
                    st = dict(st)
                    for k in ks:
                        if k in st and k in old_groups[og]:
                            st[k] = _carry_rows(st[k], old_groups[og][k], pairs)
                out.append(st)
            return out

        new["file_batches"] = carry(
            new["file_batches"], old_state["file_batches"],
            lambda g: self.file_batches[g].paths, old._bank_lane)
        # a sampler pool carries its whole state, another bank the keys
        # its node type names (BATCH_CARRY: a synth's own state)
        new["pools"] = carry(
            new["pools"], old_state["pools"], lambda g: self.pools[g].paths,
            old._pool_lane,
            lambda g: getattr(self.pools[g].proto, "BATCH_CARRY", None))
        for cid, c in enumerate(self.chains):
            for i in range(len(c["effects"][0])):
                old_loc = {}
                for eps in c["effect_paths"]:
                    loc = old._eff_loc.get(eps[i])
                    if loc is not None:
                        old_loc[eps[i]] = (loc[:2], loc[2])
                new["chains"][cid][i] = carry(
                    [new["chains"][cid][i]],
                    {k: old_state["chains"][k[0]][k[1]]
                     for k, _ in old_loc.values()},
                    lambda g: [eps[i] for eps in c["effect_paths"]],
                    old_loc)[0]
        sm = {}
        for key, st in new["smoothers"].items():
            pairs = [(i, old._param_row[pp][1])
                     for i, pp in enumerate(self._param_groups[key])
                     if pp in old._param_row]
            if key in old_state["smoothers"] and pairs:
                st = _carry_rows(st, old_state["smoothers"][key], pairs)
            sm[key] = st
        new["smoothers"] = sm
        if "bypass" in new:
            old_ages = old_state.get("bypass")
            ages = []
            for cid, c in enumerate(self.chains):
                a = torch.zeros_like(new["bypass"][cid])
                for lane, eps in enumerate(c["effect_paths"]):
                    for i, ep in enumerate(eps):
                        loc = old._eff_loc.get(ep)
                        if old_ages is None or loc is None:
                            continue
                        ocid, oi, olane = loc
                        if old.chains[ocid]["effect_paths"][olane][:oi + 1] \
                                == eps[:i + 1]:
                            a[i, lane] = old_ages[ocid][oi, olane]
                ages.append(a)
            new["bypass"] = ages
        return new

    def natural_duration_frames(self) -> Optional[int]:
        """Longest finite source duration + effect tails, or None if endless."""
        total = 0
        for path in self.source_paths:
            d = self.nodes[path].duration_frames(self.ctx)
            stop = self.stop_frames[path]
            kill = self.kill_frames[path]
            if d is None and stop == NEVER and kill == NEVER:
                return None
            limit = min(x for x in (d, stop if stop != NEVER else None,
                                    kill if kill != NEVER else None)
                        if x is not None)
            if stop != NEVER and limit == stop:
                fade = getattr(self.nodes[path], "options", None)
                limit += int((fade.fade_out_secs if fade else 0.05)
                             * self.ctx.sample_rate) + 1
            total = max(total, limit)
        return total + self._total_tail()

    def _total_tail(self) -> int:
        """Effect tails summed down each chain, the longest child mixer's
        tail under its parent's."""
        def mixer_tail(m: _FrozenMixer) -> int:
            t = max((mixer_tail(c) for c in m.children), default=0)
            for e in m.effects:
                t += e.tail_frames(self.ctx)
            return t

        return mixer_tail(self._frozen)

    # ------------------------------------------------------------------
    # state + inputs
    # ------------------------------------------------------------------

    def init_state(self):
        dev = self.device
        smoothers = {}
        for key, pps in self._param_groups.items():
            kind, arg = key
            v = torch.tensor(
                [float(self.nodes[path].param_initials().get(
                    pid, self.nodes[path].param(pid).default))
                 for path, pid in pps], dtype=torch.float32, device=dev)
            if kind == "exponential":
                smoothers[key] = smoothing.exp_smoother_init(v)
            elif kind == "linear":
                smoothers[key] = smoothing.lin_smoother_init(
                    v, step=arg, sample_rate=self.ctx.sample_rate)
            elif kind == "spring":
                smoothers[key] = smoothing.spring_smoother_init(v)
            else:
                smoothers[key] = v  # stepped: carry the current target
        chains = [
            [stack_states([effs[i].init_state(self.ctx) for effs in c["effects"]]
                          * self.lanes)
             for i in range(len(c["effects"][0]))]
            for c in self.chains]
        st = {"smoothers": smoothers,
              "file_batches": [b.init_state() for b in self.file_batches],
              "pools": [p.init_state() for p in self.pools],
              "chains": chains}
        if self.config.auto_bypass:
            # one silence age per (stage, lane) of each chain, [E, L*G]:
            # every effect starts bypassed until audio arrives
            st["bypass"] = [torch.full(c["limits"].shape, AGE_MAX,
                                       dtype=torch.int32, device=dev)
                            for c in self.chains]
        return st

    def _share_control_from(self, other: "RenderProgram"):
        """Lower blocks with ``other``'s control state (timelines, stop /
        kill schedules): a lane-batched twin of a program keeps taking the
        automation scheduled on the program.  Both programs must be built
        from the same root."""
        if other.root is not self.root:
            raise ValueError("control sharing requires the same graph root")
        self.timelines = other.timelines
        self.stop_frames = other.stop_frames
        self.kill_frames = other.kill_frames
        for path, node in self.nodes.items():
            node._timelines = {p.id: self.timelines[(path, p.id)]
                               for p in node.PARAMS}

    def block_inputs(self, block_index: int):
        """Host-side lowering of one block's events (numpy)."""
        n = self.ctx.block_frames
        start = block_index * n
        with tracing.span("engine.lower", block_index):
            params = {}
            with tracing.span("engine.lower.params"):
                for key, pps in self._param_groups.items():
                    lowered = [self.timelines[pp].lower_block(
                        start, n, self.ctx.max_events) for pp in pps]
                    params[key] = tuple(np.stack(x) for x in zip(*lowered))
            extra = {}
            with tracing.span("engine.lower.nodes"):
                for path, node in self.nodes.items():
                    node_extra = node.lower_block_inputs(start, n)
                    if node_extra:
                        extra[path] = node_extra
            stops = {path: (self.stop_frames[path], self.kill_frames[path])
                     for path in self.source_paths}
        return {"frame0": start, "params": params, "stops": stops,
                "extra": extra}

    def stacked_inputs(self, num_blocks: int, start_block: int = 0):
        """The inputs of blocks ``start_block .. start_block + num_blocks -
        1``, stacked along a leading block axis: ``frame0`` [blocks], each
        parameter group's (times, values, ramps) [blocks, P, K], each
        source's (stop, kill) frames [blocks], and ``extra``, the nodes'
        own lowering, as a list with one dict per block (its arrays may
        change shape from block to block).  The timelines lower in
        O(events) (``ParamTimeline.lower_all``); :meth:`block_of` gives
        block i's inputs, equal to :meth:`block_inputs` of that block."""
        n = self.ctx.block_frames
        end = start_block + num_blocks
        params = {}
        for key, pps in self._param_groups.items():
            lowered = [self.timelines[pp].lower_all(end, n, self.ctx.max_events)
                       for pp in pps]
            params[key] = tuple(np.stack([a[start_block:] for a in x], axis=1)
                                for x in zip(*lowered))
        stops = {path: (np.full(num_blocks, self.stop_frames[path], np.int64),
                        np.full(num_blocks, self.kill_frames[path], np.int64))
                 for path in self.source_paths}
        extra = []
        for b in range(start_block, end):
            extra.append({path: e for path, node in self.nodes.items()
                          if (e := node.lower_block_inputs(b * n, n))})
        return {"frame0": np.arange(start_block, end, dtype=np.int64) * n,
                "params": params, "stops": stops, "extra": extra}

    @staticmethod
    def block_of(stacked, i: int):
        """Block ``i`` of :meth:`stacked_inputs` as :meth:`block_inputs`
        gives it."""
        return {"frame0": int(stacked["frame0"][i]),
                "params": {k: tuple(a[i] for a in v)
                           for k, v in stacked["params"].items()},
                "stops": {p: (int(s[i]), int(k[i]))
                          for p, (s, k) in stacked["stops"].items()},
                "extra": stacked["extra"][i]}

    # ------------------------------------------------------------------
    # the arrays a block copies to the device
    # ------------------------------------------------------------------

    def _lane_inputs(self, inputs) -> Optional[list]:
        """None for a block's shared inputs (one dict); for per-lane inputs
        (a sequence of dicts) the list of them, checked against the
        program: one per lane, each lowered by a program of a structurally
        equal graph (the same parameter groups and rows, source paths and
        nodes), at any ``frame0``.  A ``ValueError`` names the first
        difference."""
        if isinstance(inputs, dict):
            return None
        lanes = list(inputs)
        if len(lanes) != self.lanes:
            raise ValueError(f"{len(lanes)} lanes of inputs for a program "
                             f"of {self.lanes} lanes")
        paths = set(self.source_paths)
        for k, d in enumerate(lanes):
            if set(d["params"]) != set(self._param_groups):
                raise ValueError(
                    f"lane {k}'s parameter groups "
                    f"{sorted(set(d['params']) ^ set(self._param_groups))} "
                    "differ from the program's")
            for key, pps in self._param_groups.items():
                rows = np.shape(d["params"][key][0])[0]
                if rows != len(pps):
                    raise ValueError(
                        f"lane {k}'s parameter group {key} has {rows} rows, "
                        f"the program's {len(pps)}")
            if set(d["stops"]) != paths:
                raise ValueError(
                    f"lane {k}'s source paths "
                    f"{sorted(set(d['stops']) ^ paths)} differ from the "
                    "program's")
            unknown = set(d.get("extra", {})) - set(self.nodes)
            if unknown:
                raise ValueError(f"lane {k} lowers inputs for nodes the "
                                 f"program lacks: {sorted(unknown)}")
        return lanes

    def _block_index(self, inputs) -> int:
        """The index of the block that ``inputs`` (shared, or per lane: the
        first lane's) serve, which its spans carry."""
        first = inputs if isinstance(inputs, dict) else next(iter(inputs))
        return int(first["frame0"]) // self.ctx.block_frames

    def _host_arrays(self, inputs):
        """The host arrays of a block's inputs that the step reads on the
        device, by name, and the host values derived from them that the
        step reads on the host (segment counts, a pool's layout and step
        bound).  Values that pick code paths (an effect's flags) stay in
        ``inputs``.  Per-lane inputs give each parameter group ``[L*P, K]``
        event rows and every bank its lanes' rows, lane-major; lanes whose
        blocks start at different frames give every bank its rows' start
        frames (``b{i}.f0``, ``q{i}.f0``)."""
        n = self.ctx.block_frames
        arrays, host = {}, {}
        per = self._lane_inputs(inputs)
        starts = per is not None and len({int(d["frame0"]) for d in per}) > 1

        def cat(get, dtype=None):  # a group's event rows
            if per is None:
                return np.asarray(get(inputs), dtype)
            return np.concatenate([np.asarray(get(d), dtype) for d in per])

        for gi, key in enumerate(self._param_groups):
            arrays[f"p{gi}.t"] = cat(lambda d: d["params"][key][0], np.int64)
            arrays[f"p{gi}.v"] = cat(lambda d: d["params"][key][1], np.float32)
            if key[0] not in ("exponential", "linear", "spring"):
                arrays[f"p{gi}.r"] = cat(lambda d: d["params"][key][2])
            host[f"p{gi}.live"] = smoothing.live_segments(arrays[f"p{gi}.t"],
                                                          n)
        # (lane inputs, extra) per lane; shared inputs repeat one lane's
        lane_dicts = ([(inputs, inputs.get("extra", {}))] * self.lanes
                      if per is None else [(d, d.get("extra", {})) for d in per])
        for bi, batch in enumerate(self.file_batches):
            def lanes(fn, dtype):
                return np.array([fn(d, ex, p) for d, ex in lane_dicts
                                 for p in batch.paths], dtype)

            arrays[f"b{bi}.stop"] = lanes(lambda d, ex, p: d["stops"][p][0],
                                          np.int64)
            arrays[f"b{bi}.kill"] = lanes(lambda d, ex, p: d["stops"][p][1],
                                          np.int64)
            arrays[f"b{bi}.seek_flag"] = lanes(
                lambda d, ex, p: ex.get(p, {}).get("_seek_flag", 0.0),
                np.float32)
            arrays[f"b{bi}.seek_pos"] = lanes(
                lambda d, ex, p: ex.get(p, {}).get("_seek_pos", 0.0),
                np.float32)
            if starts:
                arrays[f"b{bi}.f0"] = lanes(lambda d, ex, p: d["frame0"],
                                            np.int64)
        for pi, pool in enumerate(self.pools):
            # one instance's nodes (repeated on the device), or every lane's
            lowered = lane_dicts[:1] if per is None else lane_dicts
            try:
                flat, layout, smax, live = pool.stack([
                    bank_inputs(self.nodes[p], ex.get(p), *d["stops"][p])
                    for d, ex in lowered for p in pool.paths])
            except ValueError as e:  # lowered arrays that do not stack
                raise ValueError(f"the lanes' inputs for {pool.paths} do "
                                 f"not stack: {e}") from None
            if flat is not None:
                arrays[f"q{pi}"] = flat
            if starts:
                arrays[f"q{pi}.f0"] = np.array(
                    [d["frame0"] for d, _ in lowered for _ in pool.paths],
                    np.int64)
            host[f"q{pi}"] = (layout, smax, live)
        return arrays, host

    def pack_inputs(self, inputs) -> PackedInputs:
        """A block's inputs for :meth:`step_packed`: every host array the
        step reads on the device goes into one buffer (pinned on a CUDA
        program), each at an 8-byte-aligned offset, which goes to the
        device in one asynchronous copy; the step reads views of it.

        The layout (names, shapes, dtypes, offsets) is kept while a block's
        arrays keep it; a change (the first note event lowering new arrays,
        a retuned pool) makes a new layout and bumps ``_pack_version``.
        The buffer is fresh per block: PyTorch's pinned-memory cache hands
        a buffer out again only once the copy that read it has completed."""
        with tracing.span("engine.upload", self._block_index(inputs)):
            arrays, host = self._host_arrays(inputs)
            sig = tuple((k, a.shape, a.dtype.str) for k, a in arrays.items())
            if self._pack_spec is None or self._pack_spec[0] != sig:
                offsets, off = [], 0
                for _, a in arrays.items():
                    offsets.append(off)
                    off += -(-a.nbytes // 8) * 8
                self._pack_spec = (sig, tuple(offsets), max(off, 8))
                self._pack_version += 1
            _, offsets, total = self._pack_spec
            pinned = self.device.type == "cuda"
            buf = torch.empty(total, dtype=torch.uint8, pin_memory=pinned)
            view = buf.numpy()
            for off, a in zip(offsets, arrays.values()):
                view[off:off + a.nbytes] = np.ascontiguousarray(a).view(
                    np.uint8).reshape(-1)
            dbuf = buf.to(self.device, non_blocking=True) if pinned else buf
            device = {}
            for off, (k, a) in zip(offsets, arrays.items()):
                t = dbuf[off:off + a.nbytes].view(_TORCH[a.dtype.str])
                device[k] = t.view(a.shape)
        return PackedInputs(inputs, host, device)

    def packed_block_inputs(self, block_index: int) -> PackedInputs:
        return self.pack_inputs(self.block_inputs(block_index))

    # ------------------------------------------------------------------
    # the block step
    # ------------------------------------------------------------------

    def _smooth_all_params(self, smoother_state, host, dev):
        """Run every parameter group's smoother, each group as one batched
        computation (one kernel launch on the card,
        ``ops/smoothing.smooth_group``); returns (new_smoother_states,
        values[key] -> [P, n]).  A group's events may be per lane over a
        shared state (the first per-lane block widens it from [P] to
        [L*P] rows, lane-major) or shared over per-lane states (every lane
        takes them)."""
        n = self.ctx.block_frames
        sr = self.ctx.sample_rate
        new_states, group_values = {}, {}
        for gi, key in enumerate(self._param_groups):
            kind, arg = key
            ev = smoothing.SegmentEvents(dev[f"p{gi}.t"], dev[f"p{gi}.v"],
                                         host[f"p{gi}.live"])
            new_states[key], group_values[key] = smoothing.smooth_group(
                kind, arg, sr, smoother_state[key], ev, n, dev.get(f"p{gi}.r"))
        return new_states, group_values

    def step(self, state, inputs):
        """Render one block: (state, inputs) -> (state, audio[ch, n]) on the
        program's device (``audio[lanes, ch, n]`` for a program built with
        ``lanes``); with ``meter_mixers`` the output is (audio,
        :class:`MixerLevels`, its levels ``[lanes, ch]`` likewise).  The
        block's arrays reach the device in one copy (:meth:`pack_inputs`)."""
        return self.step_packed(state, self.pack_inputs(inputs))

    def step_packed(self, state, packed: PackedInputs):
        """:meth:`step` over :meth:`pack_inputs`' packed inputs, with no copy
        from the host and no wait for the stream inside it."""
        with tracing.span("engine.step", self._block_index(packed.inputs)):
            return self._walk(state, packed.inputs, packed.host,
                              packed.device)

    def _walk(self, state, inputs, host, dev):
        """The graph walked over one block, from the block's device arrays
        ``dev`` and host values ``host`` (:meth:`_host_arrays`)."""
        ctx = self.ctx
        lanes = self.lanes
        per = None if isinstance(inputs, dict) else list(inputs)
        # the banks take this one start frame as a host int, or their rows'
        # own as a device tensor where the lanes' differ (``b{i}.f0``,
        # ``q{i}.f0``); nothing on the host decides on it
        frame0 = int((per or [inputs])[0]["frame0"])
        # each lane's nodes' own inputs, lane-major
        extras = ([inputs.get("extra", {})] * lanes if per is None
                  else [d.get("extra", {}) for d in per])
        with tracing.span("engine.smooth"):
            new_smoothers, values = self._smooth_all_params(
                state["smoothers"], host, dev)

        def per_lane(key):  # the group's values differ between lanes
            return values[key].shape[0] != len(self._param_groups[key])

        def rows(sel):
            key, shared, lane = sel
            return values[key].index_select(0, lane if per_lane(key)
                                            else shared)

        # file-source lane banks render first; render_pre consumes their rows
        # (each source's [L, ch, n]: its rows of every instance)
        source_out: dict[str, torch.Tensor] = {}
        new_batches = []
        for bi, batch in enumerate(self.file_batches):
            sel = self._batch_rows[bi]
            args = [rows(sel["VOLU"]), rows(sel["PANN"]), rows(sel["SPED"])]
            names = [f"b{bi}.{k}" for k in ("stop", "kill", "seek_flag",
                                             "seek_pos")]
            f0 = dev.get(f"b{bi}.f0", frame0)
            with tracing.span("source.file_bank"):
                nb_state, out = batch.render(
                    state["file_batches"][bi], f0, *args,
                    *(dev[k] for k in names),
                    speeds_differ=per_lane(sel["SPED"][0]))
            new_batches.append(nb_state)
            out = out.view((lanes, len(batch.paths)) + out.shape[1:])
            for i, p in enumerate(batch.paths):
                source_out[p] = out[:, i]
        new_pools = []
        for pi, pool in enumerate(self.pools):
            params = {pid: rows(sel) for pid, sel in self._pool_rows[pi].items()}
            f0 = dev.get(f"q{pi}.f0", frame0)
            layout, smax, live = host[f"q{pi}"]
            with tracing.span("source.pool"):
                pool_state, out = pool.render(
                    state["pools"][pi], params,
                    pool.voices(dev.get(f"q{pi}"), layout), smax, live, f0)
            new_pools.append(pool_state)
            out = out.view((lanes, len(pool.paths)) + out.shape[1:])
            for i, p in enumerate(pool.paths):
                source_out[p] = out[:, i]

        new_chains: list = [None] * len(self.chains)
        new_ages: list = [None] * len(self.chains)
        metered: list = []  # (mixer path, its post-effects signal)
        bypass = self.config.auto_bypass

        def run_chain(cid, x):
            """Apply chain ``cid`` to x [L*G, ch, n]: effect i of every lane
            runs as one batched call."""
            c = self.chains[cid]

            def stage_params(i):
                pvals = {pid: rows(sel) for pid, sel in c["params"][i].items()}
                dicts = [ex.get(eps[i], {}) for ex in extras
                         for eps in c["effect_paths"]]
                for k in sorted(set().union(*dicts)):
                    pvals[k] = np.stack([d.get(k, 0) for d in dicts])
                return pvals

            new_chains[cid], new_ages[cid], x = c["run"](
                x, state["chains"][cid],
                state["bypass"][cid] if bypass else None, stage_params)
            return x

        def render_pre(m: _FrozenMixer, me: str):
            """Children and sources summed, BEFORE m's own effect chain:
            [L, ch, n]."""
            acc = torch.zeros((lanes, ctx.channels, ctx.block_frames),
                              dtype=self.config.dtype, device=self.device)
            done = set()
            for child in m.children:
                cpath = f"{me}/{child.name}"
                cid = self._chain_of.get(cpath)
                if cid is None:
                    y = render_pre(child, cpath)
                    metered.append((cpath, y))
                    acc = acc + y
                    continue
                if cid in done:
                    continue
                done.add(cid)
                c = self.chains[cid]
                # [L, G, ch, n] -> the chain's lane-major [L*G, ch, n]
                xs = torch.stack([render_pre(m2, p2) for m2, p2 in
                                  zip(c["mixers"], c["mixer_paths"])], dim=1)
                ys = run_chain(cid, xs.flatten(0, 1)).unflatten(0, xs.shape[:2])
                metered.extend((p, ys[:, g])
                               for g, p in enumerate(c["mixer_paths"]))
                acc = acc + torch.sum(ys, dim=1)
            for s in m.sources:
                acc = acc + source_out[f"{me}/{s.name}"]
            return acc

        me = self._frozen.name
        audio = render_pre(self._frozen, me)
        if me in self._chain_of:
            audio = run_chain(self._chain_of[me], audio)
        metered.append((me, audio))
        if not self._lane_axis:
            audio = audio[0]
            metered = [(p, y[0]) for p, y in metered]
        new_state = {"smoothers": new_smoothers, "file_batches": new_batches,
                     "pools": new_pools, "chains": new_chains}
        if self.config.auto_bypass:
            new_state["bypass"] = new_ages
        if not self.config.meter_mixers:
            return new_state, audio
        # per-mixer metering (reference: MeteredSource on every mixer,
        # src/player.rs:444-459): every mixer's levels in one reduction
        with tracing.span("engine.meter"):
            sig = torch.stack([y for _, y in metered])
            stats = torch.stack([
                torch.amax(torch.abs(sig), dim=-1),
                torch.sqrt(torch.mean(torch.square(sig), dim=-1))])
        return new_state, (audio, MixerLevels([p for p, _ in metered], stats))

    # ------------------------------------------------------------------
    # rendering
    # ------------------------------------------------------------------

    def render(self, duration_frames: Optional[int] = None,
               state=None) -> np.ndarray:
        """Offline render of the first ``duration_frames`` frames to a planar
        float32 array [channels, frames]: a host loop over blocks, one
        device-to-host copy at the end.  Without a length the render runs
        to :meth:`natural_duration_frames`; an endless graph then raises.

        The JAX package's ``mode=`` argument chooses between a ``lax.scan``
        over blocks and a host loop; nothing is compiled here, so the host
        loop is the only mode and the argument has no counterpart."""
        if duration_frames is None:
            duration_frames = self.natural_duration_frames()
            if duration_frames is None:
                raise ValueError(
                    "graph has endless sources; pass an explicit duration")
        if self.config.meter_mixers:
            raise ValueError(
                "offline render() does not support meter_mixers; use the "
                "Player pump or a plain config")
        n = self.ctx.block_frames
        num_blocks = max((int(duration_frames) + n - 1) // n, 1)
        state = state if state is not None else self.init_state()
        chunks = []
        for b in range(num_blocks):
            state, y = self.step(state, self.block_inputs(b))
            chunks.append(y)
        audio = torch.cat(chunks, dim=-1)[..., :duration_frames]
        return audio.to(torch.float32).cpu().numpy()
