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
"""

from __future__ import annotations

import bisect
from typing import Optional, Union

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, DEFAULT_INERTIA, EngineConfig, resolve_device
from ..errors import NotFoundError
from ..events import ParamTimeline
from ..generators.sampler import Sampler
from ..ops import smoothing
from ..sources.file import NEVER, FileSource
from .batching import FileBatch, LeafBatch, group_key as _file_group_key
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


def _freeze_mixer(m: Mixer) -> _FrozenMixer:
    return _FrozenMixer(m.name, tuple(m.sources), tuple(m.effects),
                        tuple(_freeze_mixer(c) for c in m.children))


def stack_states(states: list):
    """Stack per-lane states (dicts / NamedTuples of tensors) along a new
    leading dimension."""
    s0 = states[0]
    if isinstance(s0, torch.Tensor):
        return torch.stack(states)
    if isinstance(s0, dict):
        return {k: stack_states([s[k] for s in states]) for k in s0}
    return type(s0)(*(stack_states(list(xs)) for xs in zip(*states)))


class RenderProgram:
    """A render program for one graph topology on one device."""

    def __init__(self, root: Mixer, config: EngineConfig = DEFAULT_CONFIG,
                 device: Optional[Union[str, torch.device]] = None):
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
            if kind == "source" and type(obj) not in (FileSource, Sampler):
                raise NotImplementedError(
                    f"{type(obj).__name__} sources are not ported yet")
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
        """(group key, row-index tensor) selecting parameter ``pid`` of each
        node path (all rows of one parameter share a smoother group)."""
        keys = {self._param_row[(p, pid)][0] for p in paths}
        if len(keys) != 1:
            raise ValueError(f"{pid}: lanes smooth differently ({keys})")
        rows = [self._param_row[(p, pid)][1] for p in paths]
        return keys.pop(), torch.tensor(rows, dtype=torch.int64,
                                        device=self.device)

    def _build_source_batches(self):
        """Every file source renders as a lane of a FileBatch: one bank per
        group of homogeneous sources; every sampler as part of a generator
        pool (LeafBatch): one pool per ``source_batch_key``.  With
        ``batch_sources`` off, each source is a bank or pool of its own."""
        groups: dict[tuple, list[str]] = {}
        pools: dict[tuple, list[str]] = {}
        batch = self.config.batch_sources
        for i, path in enumerate(self.source_paths):
            node = self.nodes[path]
            if isinstance(node, Sampler):
                key = node.source_batch_key(self.ctx) if batch else i
                pools.setdefault(key, []).append(path)
            else:
                key = _file_group_key(node) if batch else i
                groups.setdefault(key, []).append(path)
        self.file_batches: list[FileBatch] = []
        self._batch_rows: list[dict] = []
        for paths in groups.values():
            self.file_batches.append(
                FileBatch([self.nodes[p] for p in paths], paths, self.ctx))
            self._batch_rows.append(
                {pid: self._rows(paths, pid) for pid in ("VOLU", "PANN", "SPED")})
        self.pools: list[LeafBatch] = []
        self._pool_rows: list[dict] = []
        for paths in pools.values():
            pool = LeafBatch([self.nodes[p] for p in paths], paths, self.ctx)
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
        lists; ``self._chain_of`` maps a mixer path to its chain."""
        self.chains: list[dict] = []
        self._chain_of: dict[str, int] = {}

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
            self.chains.append({"mixers": list(mixers), "mixer_paths": paths,
                                "effects": effects, "effect_paths": epaths,
                                "params": params})
            for p in paths:
                self._chain_of[p] = cid

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
            [stack_states([effs[i].init_state(self.ctx) for effs in c["effects"]])
             for i in range(len(c["effects"][0]))]
            for c in self.chains]
        return {"smoothers": smoothers,
                "file_batches": [b.init_state() for b in self.file_batches],
                "pools": [p.init_state() for p in self.pools],
                "chains": chains}

    def block_inputs(self, block_index: int):
        """Host-side lowering of one block's events (numpy)."""
        n = self.ctx.block_frames
        start = block_index * n
        params = {}
        for key, pps in self._param_groups.items():
            lowered = [self.timelines[pp].lower_block(start, n, self.ctx.max_events)
                       for pp in pps]
            params[key] = tuple(np.stack(x) for x in zip(*lowered))
        extra = {}
        for path, node in self.nodes.items():
            node_extra = node.lower_block_inputs(start, n)
            if node_extra:
                extra[path] = node_extra
        stops = {path: (self.stop_frames[path], self.kill_frames[path])
                 for path in self.source_paths}
        return {"frame0": start, "params": params, "stops": stops,
                "extra": extra}

    # ------------------------------------------------------------------
    # the block step
    # ------------------------------------------------------------------

    def _smooth_all_params(self, smoother_state, inputs_params):
        """Run every parameter group's smoother as one batched computation;
        returns (new_smoother_states, values[key] -> [P, n])."""
        n = self.ctx.block_frames
        sr = self.ctx.sample_rate
        new_states, group_values = {}, {}
        for key in self._param_groups:
            kind, arg = key
            t, v, r = inputs_params[key]
            ev = smoothing.segment_events(t, v, n, self.device)
            st = smoother_state[key]
            if kind == "exponential":
                new, vals = smoothing.exp_smoother_block(
                    st, ev, n, smoothing.exp_alpha(arg, sr))
            elif kind == "linear":
                new, vals = smoothing.lin_smoother_block(st, ev, n)
            elif kind == "spring":
                new, vals = smoothing.spring_smoother_block(
                    st, ev, n, smoothing.spring_omega(arg), sr)
            else:
                ramps = torch.as_tensor(r, device=self.device)
                new, vals = smoothing.step_targets(st, ev, ramps, n)
            new_states[key] = new
            group_values[key] = vals
        return new_states, group_values

    def step(self, state, inputs):
        """Render one block: (state, inputs) -> (state, audio[ch, n]) on the
        program's device."""
        dev = self.device
        ctx = self.ctx
        frame0 = int(inputs["frame0"])
        extra = inputs.get("extra", {})
        new_smoothers, values = self._smooth_all_params(
            state["smoothers"], inputs["params"])

        def rows(sel):
            key, idx = sel
            return values[key].index_select(0, idx)

        # file-source lane banks render first; render_pre consumes their rows
        source_out: dict[str, torch.Tensor] = {}
        new_batches = []
        for bi, batch in enumerate(self.file_batches):
            sel = self._batch_rows[bi]

            def lane_values(fn, dtype):
                return torch.tensor([fn(p) for p in batch.paths], dtype=dtype,
                                    device=dev)

            nb_state, out = batch.render(
                state["file_batches"][bi], frame0, rows(sel["VOLU"]),
                rows(sel["PANN"]), rows(sel["SPED"]),
                lane_values(lambda p: inputs["stops"][p][0], torch.int64),
                lane_values(lambda p: inputs["stops"][p][1], torch.int64),
                lane_values(lambda p: extra.get(p, {}).get("_seek_flag", 0.0),
                            torch.float32),
                lane_values(lambda p: extra.get(p, {}).get("_seek_pos", 0.0),
                            torch.float32),
            )
            new_batches.append(nb_state)
            for i, p in enumerate(batch.paths):
                source_out[p] = out[i]
        new_pools = []
        for pi, pool in enumerate(self.pools):
            params = {pid: rows(sel) for pid, sel in self._pool_rows[pi].items()}
            pool_state, out = pool.render(state["pools"][pi], params,
                                          [extra[p] for p in pool.paths])
            new_pools.append(pool_state)
            for i, p in enumerate(pool.paths):
                source_out[p] = out[i]

        new_chains: list = [None] * len(self.chains)

        def run_chain(cid, x):
            """Apply chain ``cid`` to x [G, ch, n]: effect i of every lane
            runs as one batched call."""
            c = self.chains[cid]
            sts = []
            for i, e0 in enumerate(c["effects"][0]):
                pvals = {pid: rows(sel) for pid, sel in c["params"][i].items()}
                dicts = [extra.get(eps[i], {}) for eps in c["effect_paths"]]
                for k in sorted(set().union(*dicts)):
                    pvals[k] = np.stack([d.get(k, 0) for d in dicts])
                st, x = e0.process(state["chains"][cid][i], x, pvals, ctx)
                sts.append(st)
            new_chains[cid] = sts
            return x

        def render_pre(m: _FrozenMixer, me: str):
            """Children and sources summed, BEFORE m's own effect chain."""
            acc = torch.zeros((ctx.channels, ctx.block_frames),
                              dtype=self.config.dtype, device=dev)
            done = set()
            for child in m.children:
                cpath = f"{me}/{child.name}"
                cid = self._chain_of.get(cpath)
                if cid is None:
                    acc = acc + render_pre(child, cpath)
                    continue
                if cid in done:
                    continue
                done.add(cid)
                c = self.chains[cid]
                xs = torch.stack([render_pre(m2, p2) for m2, p2 in
                                  zip(c["mixers"], c["mixer_paths"])])
                acc = acc + torch.sum(run_chain(cid, xs), dim=0)
            for s in m.sources:
                acc = acc + source_out[f"{me}/{s.name}"]
            return acc

        me = self._frozen.name
        audio = render_pre(self._frozen, me)
        if me in self._chain_of:
            audio = run_chain(self._chain_of[me], audio[None])[0]
        new_state = {"smoothers": new_smoothers, "file_batches": new_batches,
                     "pools": new_pools, "chains": new_chains}
        return new_state, audio

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
        n = self.ctx.block_frames
        num_blocks = max((int(duration_frames) + n - 1) // n, 1)
        state = state if state is not None else self.init_state()
        chunks = []
        for b in range(num_blocks):
            state, y = self.step(state, self.block_inputs(b))
            chunks.append(y)
        audio = torch.cat(chunks, dim=-1)[:, :duration_frames]
        return audio.to(torch.float32).cpu().numpy()
