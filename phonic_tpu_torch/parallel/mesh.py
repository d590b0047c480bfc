"""Lane-batched rendering: independent instances of one graph in every
launch (port of ``phonic_tpu/parallel/mesh.py``).

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
  copies them once per device;
* for lanes that differ (stems, variations with their own automation,
  notes, stops and seeks), a caller builds one program per lane from a
  structurally equal graph (the same mixer tree, node names and types),
  schedules each, and passes the sequence of their ``block_inputs(b)``,
  lane-major, to :meth:`~BatchedRenderProgram.step` (or of their
  ``stacked_inputs`` to ``scan_step`` / :meth:`render_scan`).  The lane
  programs may be CPU programs: a lowering is host numpy.  A mesh of k
  devices hands each shard its lanes' slice of the sequence.

Two differences from the JAX package: every lane of a block must start at
the same ``frame0`` (the port reads it on the host to choose code paths;
JAX traces it), and a sequence whose lanes differ in structure (their
parameter groups or rows, source paths, nodes, or lowered arrays that do
not stack) raises ``ValueError`` naming the first difference.

The JAX package chooses between packed and plain inputs by lane count,
a trade of transfer latency against unpack cost on the TPU; the port
always copies the block's arrays as its single programs do, so that
choice has no counterpart.

A mesh is a list of torch devices (:func:`data_mesh`).  A mesh of k
devices splits the lanes into k contiguous shards, each a folded program
on its own device; their audio is gathered on the first device, and
``mixdown`` sums every lane there.  ``GraphShardedProgram`` (one graph's
banks split over devices) is the program itself on a mesh of one device
and is not implemented over several.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np
import torch

from ..config import resolve_device
from ..graph.engine import RenderProgram, tree_map

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


def _mesh_devices(mesh: Sequence[Device]) -> list[torch.device]:
    devices = [resolve_device(d) for d in mesh]
    if not devices:
        raise ValueError("a mesh needs at least one device")
    return devices


def graph_state_shardings(program: RenderProgram, mesh: Sequence[Device],
                          axis: str = "graph",
                          lane_axis: Optional[str] = None):
    """Where each leaf of ``program``'s state lives when its banks split
    over ``mesh``: a tree shaped as the state with a device per leaf.  On
    a mesh of one device every leaf lives on it; splitting one graph's
    banks over several devices is not implemented."""
    devices = _mesh_devices(mesh)
    if len(devices) > 1:
        raise NotImplementedError(
            "splitting one graph's banks over several devices is not "
            "implemented; render independent lanes with BatchedRenderProgram")
    return tree_map(lambda _: devices[0], program.init_state())


class GraphShardedProgram:
    """One graph's banks split over a mesh (the JAX package's
    model-parallel program, bit-identical to the unsharded one).  On a
    mesh of one device it is the program itself; over several devices it
    raises ``NotImplementedError``."""

    def __init__(self, program: RenderProgram, mesh: Sequence[Device],
                 axis: str = "graph"):
        devices = _mesh_devices(mesh)
        graph_state_shardings(program, devices, axis)
        if devices[0] != program.device:
            raise ValueError(f"the program renders on {program.device}, the "
                             f"mesh holds {devices[0]}")
        self.program = program
        self.mesh = devices
        self.step = program.step

    def init_state(self):
        return self.program.init_state()

    def block_inputs(self, block_index: int):
        return self.program.block_inputs(block_index)


class BatchedRenderProgram:
    """``lanes`` independent instances of ``program``'s graph per block,
    folded into each bank, split over ``mesh`` (default: the program's
    device)."""

    def __init__(self, program: RenderProgram, lanes: int,
                 mesh: Optional[Sequence[Device]] = None,
                 mixdown: bool = False):
        if program.lanes != 1 or program._lane_axis:
            raise ValueError("BatchedRenderProgram wraps a one-instance "
                             "program")
        devices = ([program.device] if mesh is None
                   else _mesh_devices(mesh))
        if lanes < 1 or lanes % len(devices):
            raise ValueError(f"{lanes} lanes do not split evenly over "
                             f"{len(devices)} devices")
        self.program = program
        self.lanes = lanes
        self.mesh = mesh
        self.mixdown = mixdown
        self.shards = []
        for dev in devices:
            shard = RenderProgram(program.root, program.config, device=dev,
                                  lanes=lanes // len(devices))
            shard._share_control_from(program)
            self.shards.append(shard)
        self.device = devices[0]

    def init_states(self) -> list:
        """One state per shard (a list), each holding its lanes."""
        return [s.init_state() for s in self.shards]

    def block_inputs(self, block_index: int):
        """The block's inputs, shared by every lane: one lane's lowering
        (the JAX package tiles it over the lanes; here each shard copies it
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
