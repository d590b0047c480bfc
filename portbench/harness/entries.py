"""The timed entries a window drives, chosen by a mix's ``entry``:
``lanes`` (``BatchedRenderProgram.step`` with per-lane inputs) and
``player`` (``Player.run`` into an output of the benchmark's own).

Each entry applies the traffic's events through the program's public
calls, renders, and hands every block's audio to the host inside the
window, noting the host time each block arrived.  ``log`` keeps the events
each block got, for the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from torch.profiler import record_function


class _Entry:
    def __init__(self, cfg, spec, mix, traffic, device):
        self.cfg, self.spec, self.mix, self.traffic = cfg, spec, mix, traffic
        self.device = device
        self.n = mix["block_frames"]
        self.lanes = mix.get("lanes", 1)
        self.audio = []  # host [lanes, ch, n] per block
        self.arrivals = []  # host time each block reached the host
        self.log = []  # per block, per lane: its events
        self.lower_s = 0.0  # host seconds lowering the lanes' inputs
        self.block = 0

    def _events(self, b):
        evs = [self.traffic.events(lane, b) for lane in range(self.lanes)]
        self.log.append(evs)
        return evs


def _apply(prog, nodes, ev):
    kind, key, pid, frame, value, rate = ev
    if kind == "set":
        prog.set_parameter(nodes[key], pid, value, at_frame=frame)
    elif kind == "glide":
        prog.set_parameter_glide(nodes[key], pid, value, rate, at_frame=frame)
    elif kind == "seek":
        nodes[key].seek(frame, value)
    else:
        raise ValueError(f"unknown event kind {kind!r}")


class LanesEntry(_Entry):
    """``lanes`` independent renders of the graph in one
    ``BatchedRenderProgram``; each lane's events go to its own program of
    the same graph, whose public ``block_inputs`` lowers them."""

    def __init__(self, *a):
        super().__init__(*a)
        from phonic_tpu_torch.parallel.mesh import BatchedRenderProgram
        template, _ = self.cfg.build_program(self.spec, self.n, self.device)
        self.batched = BatchedRenderProgram(template, lanes=self.lanes)
        self.lane_progs = [self.cfg.build_program(self.spec, self.n, "cpu")
                           for _ in range(self.lanes)]
        self.states = self.batched.init_states()

    def step(self, blocks: int = 1) -> int:
        """Render one block; returns the blocks rendered."""
        b = self.block
        with record_function("bench.events"):
            for (prog, nodes), evs in zip(self.lane_progs, self._events(b)):
                for ev in evs:
                    _apply(prog, nodes, ev)
        with record_function("bench.lower"):
            t0 = time.perf_counter()
            ins = [prog.block_inputs(b) for prog, _ in self.lane_progs]
            self.lower_s += time.perf_counter() - t0
        with record_function("bench.step"):
            self.states, audio = self.batched.step(self.states, ins)
        with record_function("bench.to_host"):
            self.audio.append(audio.cpu().numpy())
        self.arrivals.append(time.perf_counter())
        self.block += 1
        return 1


class _Output:
    """An output device that never blocks: it keeps each block it is given
    and the host time it arrived."""

    def __init__(self, sample_rate: int, channels: int, entry):
        from phonic_tpu_torch.outputs.base import OutputDevice

        class Out(OutputDevice):
            sample_rate = property(lambda s: sample_rate)
            channel_count = property(lambda s: channels)
            sample_position = property(lambda s: s._pos)
            _pos = 0

            def write(s, block):
                block = np.asarray(s._apply_volume(block), np.float32)
                entry.audio.append(block[None].copy())
                entry.arrivals.append(time.perf_counter())
                s._pos += block.shape[-1]

            def close(s):
                pass

        self.device = Out()


class PlayerEntry(_Entry):
    """A ``Player`` with its defaults, pumped by ``run`` in chunks of
    ``chunk_blocks``; before each chunk its events are scheduled through
    the handles with ``at=``."""

    def __init__(self, *a):
        super().__init__(*a)
        out = _Output(self.spec["sample_rate"], 2, self).device
        self.player, self.handles = self.cfg.build_player(
            self.spec, out, self.n, self.device, self.mix["pipeline_depth"])

    def step(self, blocks: int = None) -> int:
        """Run ``blocks`` blocks (a chunk by default); returns them."""
        blocks = blocks or self.mix["chunk_blocks"]
        with record_function("bench.events"):
            for b in range(self.block, self.block + blocks):
                for kind, key, pid, frame, value, _ in self._events(b)[0]:
                    if kind != "set":
                        raise ValueError(f"the player mix sends no {kind}")
                    self.handles[key].set_parameter(pid, value, at=frame)
        with record_function("bench.run"):
            self.player.run(blocks * self.n)
        self.block += blocks
        return blocks


ENTRIES = {"lanes": LanesEntry, "player": PlayerEntry}


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
