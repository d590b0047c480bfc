"""Lane-batched rendering and one graph split over devices (port of
``phonic_tpu/parallel/mesh.py``).

``BatchedRenderProgram`` renders ``lanes`` independent instances of a
program's graph (stems, variations, preview renders) block by block:
states gain the lanes, audio is ``[lanes, channels, block]``.  The JAX
package vmaps the step over a lane axis; the port has no vmap over its
hand-written kernels and needs none, because its banks already carry a
leading dimension: the lanes fold into it (``RenderProgram(lanes=...)``,
graph/engine.py).  A block of 8 lanes of the headline graph makes the
kernel launches of one lane, each over 8 times the rows.

A block's inputs are shared by the lanes or given per lane, as in the JAX
package, whose step vmaps over ``[lanes, ...]`` inputs:

* :meth:`BatchedRenderProgram.block_inputs` gives one lane's inputs,
  shared by every lane (the JAX package tiles them): a block lowers and
  packs them once per device;
* for lanes that differ (stems, variations with their own automation,
  notes, stops and seeks, or blocks that start at other frames), a caller
  builds one program per lane from a structurally equal graph (the same
  mixer tree, node names and types), schedules each, and passes the
  sequence of their ``block_inputs(b)`` (each lane any block of its own),
  lane-major, to :meth:`~BatchedRenderProgram.step` (or of their
  ``stacked_inputs`` to ``scan_step`` / :meth:`render_scan`).  The lane
  programs may be CPU programs: a lowering is host numpy.  A mesh of k
  devices hands each shard its lanes' slice of the sequence.

A sequence whose lanes differ in structure (their parameter groups or
rows, source paths, nodes, or lowered arrays that do not stack) raises
``ValueError`` naming the first difference; the JAX package fails to
stack such lanes.

The JAX package chooses between packed and plain inputs by lane count,
a trade of transfer latency against unpack cost on the TPU; the port
always packs the block's arrays into one copy, as its single programs do
(``RenderProgram.pack_inputs``), so that choice has no counterpart.

A mesh is a list of torch devices (:func:`data_mesh`); entries may repeat.
A mesh of k devices splits the lanes into k contiguous shards, each a
folded program on its own device; their audio is gathered on the first
device, and ``mixdown`` sums every lane there.

``GraphShardedProgram`` splits one graph's banks over a mesh, as the JAX
package's model-parallel program shards its internal batch axes: every
file bank, pool and sibling effect chain whose member count the mesh
divides renders as k contiguous groups of its members, each on its device
with its own kernel launches; everything else (smoothers, scalar node
state, mixers, metering, the master chain) runs on the first device, where
the shards' outputs are gathered in row order before any sum over rows, so
the audio is the unsharded program's bit for bit.  The engine knows
nothing of this: a split bank or chain stands behind the interface the
program's walk calls (a file bank's ``render``, a pool's ``voices`` and
``render``, a chain's ``run``), and the sharded program steps a copy of
the program that holds them.  A block packs once, on the first device
(``RenderProgram.pack_inputs``); each split bank takes its shards' rows
from there on the device.  A 2D mesh (a list of rows) given to
``BatchedRenderProgram`` makes each row a lane shard whose banks split
over the row's devices: the JAX package's lanes x graph layout.
"""

from __future__ import annotations

import copy
from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..config import resolve_device
from ..graph.batching import member_rows
from ..graph.engine import RenderProgram, run_stages, tree_map

Device = Union[str, torch.device]


def data_mesh(n_devices: Optional[int] = None, axis: str = "data",
              device: Device = "cuda") -> list[torch.device]:
    """The first ``n_devices`` devices of a type as a mesh: ``cuda:0`` ..
    ``cuda:{n-1}`` (all cards by default), or ``n_devices`` (default 1)
    entries of the CPU.  ``axis`` names the lane axis, as in the JAX
    package; a port mesh has only that one."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [dev] * (n_devices or 1)
    count = torch.cuda.device_count()
    n = n_devices or count
    if n > count:
        raise ValueError(f"data_mesh: {n} devices asked, {count} present")
    return [torch.device("cuda", i) for i in range(n)]


def _device(d: Device) -> torch.device:
    """``d`` as a torch device; a CUDA device without an index is the
    current card (so ``"cuda"`` and ``cuda:0`` name one mesh entry)."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _mesh_devices(mesh: Sequence[Device]) -> list[torch.device]:
    devices = [_device(d) for d in mesh]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def _is_2d(mesh) -> bool:
    return bool(mesh) and all(isinstance(r, (list, tuple)) for r in mesh)


class BankSplit:
    """One bank of a program (a file bank, a pool or a sibling chain of G
    members and L instances, rows lane-major) split into k contiguous
    groups of its members, group j on ``devices[j]``: JAX's ``P("graph")``
    over the bank's member axis."""

    def __init__(self, size: int, lanes: int, devices: list, home):
        self.devices = devices
        self.home = home
        self.lanes = lanes
        per = size // len(devices)
        self.members = [list(range(j * per, (j + 1) * per))
                        for j in range(len(devices))]
        # each shard's rows: host indices, and a slice (one instance) or an
        # index tensor on the home device
        self.rows = [member_rows(m, size, lanes) for m in self.members]
        self._sel = [slice(int(r[0]), int(r[-1]) + 1) if lanes == 1 else
                     torch.as_tensor(r, device=home) for r in self.rows]

    def take(self, x, j: int, dim: int = 0):
        """Shard j's rows of ``x`` (along ``dim``): a tensor on the home
        device comes to shard j's device, a host array stays on the host,
        and a host int (a block's one start frame) is every shard's."""
        if isinstance(x, int):
            return x
        if isinstance(x, np.ndarray):
            return np.take(x, self.rows[j], axis=dim)
        sel = self._sel[j]
        if isinstance(sel, slice):
            x = x.narrow(dim, sel.start, sel.stop - sel.start)
        else:
            x = x.index_select(dim, sel)
        return x.to(self.devices[j])

    def gather(self, outs: list, dim: int = 0):
        """The shards' rows back on the home device, in row order."""
        outs = [o.to(self.home) for o in outs]
        if self.lanes == 1:
            return torch.cat(outs, dim=dim)
        parts = [o.unflatten(dim, (self.lanes, -1)) for o in outs]
        return torch.cat(parts, dim=dim + 1).flatten(dim, dim + 1)

    def run(self, fn):
        """``fn(j) -> (*states, out)`` on every shard j: each of the states
        as a list of the shards', and the outputs gathered."""
        *states, outs = zip(*(fn(j) for j in range(len(self.devices))))
        return (*map(list, states), self.gather(list(outs)))


class _ShardedBank:
    """A file bank or pool split over a mesh, behind the bank's own
    interface: its state is a list of its shards' states; shard j renders
    ``views[j]`` (the bank's :meth:`shard` of its members) on
    ``split.devices[j]`` from its rows of the whole bank's inputs
    (``split.take``), and the outputs come back to the home device in row
    order (``split.gather``)."""

    def __init__(self, bank, split: BankSplit):
        self.paths = bank.paths
        self.split = split
        self.views = [bank.shard(m, d)
                      for m, d in zip(split.members, split.devices)]


class _ShardedFileBank(_ShardedBank):
    def render(self, states, frame0, *rows, speeds_differ=False):
        take = self.split.take
        return self.split.run(lambda j: self.views[j].render(
            states[j], take(frame0, j), *(take(a, j) for a in rows),
            speeds_differ=speeds_differ))


class _ShardedPool(_ShardedBank):
    """The pool's lowered arrays reach each shard as its rows of the
    block's packed flat array (``LeafBatch.stack``), with the whole pool's
    step bound and live segments."""

    def __init__(self, pool, split: BankSplit):
        super().__init__(pool, split)
        self.stack = pool.stack
        self._layout = self._index = None

    def _flat_rows(self, layout, j: int):
        """Shard j's index into a flat array of ``layout``, on the home
        device, and the layout of what it selects: each array's rows are
        one instance's members ([G, ...], shared inputs of a lane-batched
        program) or every instance's ([L*G, ...])."""
        sp = self.split
        idx, out, off = [np.zeros(0, np.int64)], [], 0
        for k, shape, is_float in layout:
            count = int(np.prod(shape))
            rows = np.asarray(sp.members[j] if shape[0] == len(self.paths)
                              and sp.lanes > 1 else sp.rows[j])
            per = count // shape[0]
            idx.append(off + (rows[:, None] * per
                              + np.arange(per)).reshape(-1))
            out.append((k, (len(rows),) + tuple(shape[1:]), is_float))
            off += count
        return torch.as_tensor(np.concatenate(idx), device=sp.home), tuple(out)

    def voices(self, flat, layout) -> list:
        """Each shard's lowered arrays on its device: one ``index_select``
        of ``flat`` each, by an index worked out once per layout."""
        if layout != self._layout:
            self._layout = layout
            self._index = [self._flat_rows(layout, j)
                           for j in range(len(self.views))]
        return [view.voices(None if flat is None else
                            flat.index_select(0, idx).to(d), lay)
                for view, (idx, lay), d in zip(self.views, self._index,
                                               self.split.devices)]

    def render(self, states, params, voices: list, smax, live, frame0):
        take = self.split.take
        return self.split.run(lambda j: self.views[j].render(
            states[j], {k: take(v, j) for k, v in params.items()}, voices[j],
            smax, live, take(frame0, j)))


class _ShardedChain:
    """A sibling chain split over a mesh, as the chain's ``run``
    (``run_stages``): shard j runs the chain's effects over its rows on
    ``split.devices[j]``, from its stage states and silence ages, with its
    rows' parameters and silence limits; the output comes back to the home
    device in row order."""

    def __init__(self, chain: dict, split: BankSplit, ctx):
        self.effects = chain["effects"][0]
        self.split = split
        limits = chain.get("limits")
        self.views = [(None if limits is None
                       else split.take(limits, j, dim=1),
                       ctx._replace(device=d))
                      for j, d in enumerate(split.devices)]

    def __call__(self, x, states: list, ages, stage_params):
        take = self.split.take
        pv = [stage_params(i) for i in range(len(self.effects))]
        return self.split.run(lambda j: run_stages(
            self.effects, *self.views[j], take(x, j), states[j],
            None if ages is None else ages[j],
            lambda i: {k: take(v, j) for k, v in pv[i].items()}))


def _splits(program: RenderProgram, devices: list) -> dict:
    """The banks of ``program`` a mesh of ``devices`` splits: every file
    bank, pool and sibling chain whose member count the mesh divides (the
    JAX package's rule, by source paths and chain lanes); the rest stays
    whole on the first device."""
    k = len(devices)
    out = {"file_batches": {}, "pools": {}, "chains": {}}
    if k == 1:
        return out
    sizes = {"file_batches": [len(b.paths) for b in program.file_batches],
             "pools": [len(p.paths) for p in program.pools],
             "chains": [len(c["mixers"]) for c in program.chains]}
    for kind, counts in sizes.items():
        for i, g in enumerate(counts):
            if g % k == 0:
                out[kind][i] = BankSplit(g, program.lanes, devices, devices[0])
    return out


def _place(state, splits: dict, move):
    """A program's state with each split bank's entry a list of its
    shards' (``move(leaf, split, j, dim)`` places a leaf's rows) and every
    other leaf ``move(leaf, None, None, 0)``, which places it on the first
    device."""
    def whole(t):
        return tree_map(lambda a: move(a, None, None, 0), t)

    def parts(t, sp, dim=0):
        return [tree_map(lambda a: move(a, sp, j, dim), t)
                for j in range(len(sp.devices))]

    out = {"smoothers": whole(state["smoothers"])}
    for kind in ("file_batches", "pools", "chains"):
        out[kind] = [parts(st, splits[kind][i]) if i in splits[kind]
                     else whole(st) for i, st in enumerate(state[kind])]
    if "bypass" in state:  # [stages, L*G]: the rows are the second axis
        out["bypass"] = [parts(a, splits["chains"][i], 1)
                         if i in splits["chains"] else whole(a)
                         for i, a in enumerate(state["bypass"])]
    return out


def graph_state_shardings(program: RenderProgram, mesh,
                          axis: str = "graph",
                          lane_axis: Optional[str] = None):
    """Where each leaf of ``program``'s state lives when its banks split
    over ``mesh``: a tree shaped as the state, each leaf a device, in
    which a split bank's entry (a file bank, pool or sibling chain whose
    member count the mesh divides) is a list of its shards' trees, one per
    mesh entry; everything else (smoothers, scalar node state, the master
    chain) lives on ``mesh[0]``.  A mesh of one device: every leaf on it.

    With ``lane_axis`` the mesh is 2D, a list of rows, each row a lane
    shard whose entries split its graph (``BatchedRenderProgram(...,
    mesh=mesh2d)``): one such tree per row.  ``axis`` and ``lane_axis``
    name the axes as in the JAX package; a port mesh is a list (of rows)."""
    if lane_axis is not None:
        if not _is_2d(mesh):
            raise ValueError("lane_axis needs a 2D mesh: a list of rows")
        return [graph_state_shardings(program, row, axis) for row in mesh]
    if _is_2d(mesh):
        raise ValueError("a 2D mesh needs lane_axis")
    devices = _mesh_devices(mesh)
    return _place(program.init_state(), _splits(program, devices),
                  lambda a, sp, j, dim:
                  devices[0] if sp is None else sp.devices[j])


class GraphShardedProgram:
    """One graph's banks split over a mesh (the JAX package's
    model-parallel program): every file bank, pool and sibling effect chain
    whose member count the mesh divides renders as k contiguous groups of
    its members, group j on ``mesh[j]`` with its own launches there; the
    rest (smoothers, scalar node state, mixers, metering, the master
    chain, and any bank the mesh does not divide) runs on ``mesh[0]``, the
    program's device.  A block packs once on ``mesh[0]``
    (``RenderProgram.pack_inputs``), and each split bank takes its shards'
    rows from there to their devices; the shards' outputs return to
    ``mesh[0]`` in row order before any sum over rows, so the audio is the
    unsharded program's bit for bit.  Entries may repeat (two shards on
    one card) or name the CPU (a placement check).  The program may be
    lane-batched (``RenderProgram(lanes=L)``): each shard then holds its
    members of every instance.  ``axis`` names the mesh axis, as in the
    JAX package; a port mesh has only that one."""

    def __init__(self, program: RenderProgram, mesh: Sequence[Device],
                 axis: str = "graph"):
        devices = _mesh_devices(mesh)
        if devices[0] != _device(program.device):
            raise ValueError(f"the program renders on {program.device}, the "
                             f"mesh starts with {devices[0]}")
        self.program = program
        self.mesh = devices
        self.lanes = program.lanes
        self._splits = _splits(program, devices)
        fb, pl, ch = (self._splits[k]
                      for k in ("file_batches", "pools", "chains"))
        # the program the blocks step: a copy whose split banks and chains
        # stand behind the interface the walk calls
        self._split_program = split = copy.copy(program)
        split.file_batches = [_ShardedFileBank(b, fb[i]) if i in fb else b
                              for i, b in enumerate(program.file_batches)]
        split.pools = [_ShardedPool(p, pl[i]) if i in pl else p
                       for i, p in enumerate(program.pools)]
        split.chains = [dict(c, run=_ShardedChain(c, ch[i], program.ctx))
                        if i in ch else c
                        for i, c in enumerate(program.chains)]

    def shard_state(self, state):
        """An unsharded state of the program (``init_state``, or one carried
        over with ``convert.state_from_jax``) placed on the mesh."""
        return _place(state, self._splits,
                      lambda a, sp, j, dim: a.to(self.mesh[0]) if sp is None
                      else sp.take(a, j, dim))

    def gather_state(self, state):
        """The inverse of :meth:`shard_state`: one unsharded state on
        ``mesh[0]``."""
        out = dict(state)
        for kind in ("file_batches", "pools", "chains"):
            out[kind] = [tree_map(lambda *xs, sp=self._splits[kind][i]:
                                  sp.gather(list(xs)), *st)
                         if i in self._splits[kind] else st
                         for i, st in enumerate(state[kind])]
        if "bypass" in state:
            out["bypass"] = [self._splits["chains"][i].gather(a, dim=1)
                             if i in self._splits["chains"] else a
                             for i, a in enumerate(state["bypass"])]
        return out

    def init_state(self):
        return self.shard_state(self.program.init_state())

    def block_inputs(self, block_index: int):
        return self.program.block_inputs(block_index)

    def step(self, state, inputs):
        """(state, inputs) -> (state, audio) as the program's ``step``, the
        audio on ``mesh[0]``; ``state`` from :meth:`init_state` or
        :meth:`shard_state`; ``inputs`` shared or per lane, as the
        program takes them."""
        return self._split_program.step(state, inputs)


class BatchedRenderProgram:
    """``lanes`` independent instances of ``program``'s graph per block,
    folded into each bank, split over ``mesh`` (default: the program's
    device): a list of devices, one lane shard each, or a 2D mesh, a list
    of rows, each row a lane shard whose banks split over the row's
    devices (the JAX package's lanes x graph layout)."""

    def __init__(self, program: RenderProgram, lanes: int,
                 mesh: Optional[Sequence] = None,
                 mixdown: bool = False):
        if program.lanes != 1 or program._lane_axis:
            raise ValueError("BatchedRenderProgram wraps a one-instance "
                             "program")
        # each lane shard's devices: one (a 1D mesh), or a 2D mesh's row,
        # whose entries split the shard's banks (GraphShardedProgram)
        rows = ([[_device(program.device)]] if mesh is None
                else [_mesh_devices(r) for r in mesh] if _is_2d(mesh)
                else [[d] for d in _mesh_devices(mesh)])
        if lanes < 1 or lanes % len(rows):
            raise ValueError(f"{lanes} lanes do not split evenly over "
                             f"{len(rows)} devices")
        self.program = program
        self.lanes = lanes
        self.mesh = mesh
        self.mixdown = mixdown
        self.shards = []
        for row in rows:
            shard = RenderProgram(program.root, program.config, device=row[0],
                                  lanes=lanes // len(rows))
            shard._share_control_from(program)
            self.shards.append(shard if len(row) == 1
                               else GraphShardedProgram(shard, row))
        self.device = rows[0][0]

    def init_states(self) -> list:
        """One state per shard (a list), each holding its lanes."""
        return [s.init_state() for s in self.shards]

    def block_inputs(self, block_index: int):
        """The block's inputs, shared by every lane: one lane's lowering
        (the JAX package tiles it over the lanes; here each shard packs it
        to its device once)."""
        return self.program.block_inputs(block_index)

    def _split(self, inputs) -> list:
        """Each shard's inputs: shared inputs whole, a sequence of per-lane
        inputs (one per lane) in slices."""
        if isinstance(inputs, dict):
            return [inputs] * len(self.shards)
        lanes = list(inputs)
        if len(lanes) != self.lanes:
            raise ValueError(f"{len(lanes)} lanes of inputs for "
                             f"{self.lanes} lanes")
        per = self.lanes // len(self.shards)
        return [lanes[j * per:(j + 1) * per] for j in range(len(self.shards))]

    def step(self, states: list, inputs):
        """(states, inputs) -> (states, audio [lanes, ch, n]), or ``[1, ch,
        n]``, the sum of the lanes, with ``mixdown``; on the first device
        of the mesh.  ``inputs``: one block's inputs, shared by the lanes
        (:meth:`block_inputs`), or a sequence of ``lanes`` of them, lane k's
        lowered by its own program of a structurally equal graph (module
        docstring)."""
        new_states, outs = [], []
        for shard, st, x in zip(self.shards, states, self._split(inputs)):
            st, y = shard.step(st, x)
            new_states.append(st)
            if self.mixdown:
                y = torch.sum(y, dim=0, keepdim=True)
            outs.append(y.to(self.device))
        if self.mixdown:
            audio = outs[0]
            for y in outs[1:]:
                audio = audio + y
        else:
            audio = outs[0] if len(outs) == 1 else torch.cat(outs)
        return new_states, audio

    def _num_blocks(self, duration_frames: int) -> int:
        n = self.program.ctx.block_frames
        return max((int(duration_frames) + n - 1) // n, 1)

    def render(self, duration_frames: int) -> np.ndarray:
        """``duration_frames`` of every lane: numpy [lanes, ch, frames]."""
        states = self.init_states()
        outs = []
        for b in range(self._num_blocks(duration_frames)):
            states, audio = self.step(states, self.block_inputs(b))
            outs.append(audio)
        audio = torch.cat(outs, dim=-1)[..., :duration_frames]
        return audio.to(torch.float32).cpu().numpy()

    # -- many blocks in one call --

    def stacked_inputs(self, num_blocks: int, start_block: int = 0):
        """Blocks ``start_block ..`` ``start_block + num_blocks - 1``'s
        inputs, stacked (``RenderProgram.stacked_inputs``), shared by every
        lane."""
        return self.program.stacked_inputs(num_blocks, start_block)

    @property
    def scan_step(self):
        """``(states, stacked_inputs) -> (states, audio)`` with audio
        ``[lanes, channels, num_blocks * block_frames]``: the JAX package's
        ``lax.scan`` over blocks is a host loop over the stacked blocks
        here (nothing is compiled), and gives :meth:`render`'s arrays bit
        for bit.  ``stacked_inputs``: one :meth:`stacked_inputs`, shared by
        the lanes, or a sequence of ``lanes`` of them (the lane programs'
        own ``stacked_inputs``)."""
        def scan(states, stacked):
            shared = isinstance(stacked, dict)
            blocks = len((stacked if shared else stacked[0])["frame0"])
            outs = []
            for i in range(blocks):
                states, audio = self.step(
                    states, RenderProgram.block_of(stacked, i) if shared
                    else [RenderProgram.block_of(s, i) for s in stacked])
                outs.append(audio)
            return states, torch.cat(outs, dim=-1)
        return scan

    def render_scan(self, duration_frames: int, states=None,
                    inputs=None) -> np.ndarray:
        """``duration_frames`` of every lane through :attr:`scan_step`:
        numpy [lanes, ch, frames].  ``inputs``: the stacked inputs of the
        blocks that cover it, shared or per lane (:attr:`scan_step`); by
        default the program's own, shared."""
        states = states if states is not None else self.init_states()
        if inputs is None:
            inputs = self.stacked_inputs(self._num_blocks(duration_frames))
        _, audio = self.scan_step(states, inputs)
        return audio[..., :duration_frames].to(torch.float32).cpu().numpy()
