"""File-source lane banks, generator pools and the other leaf banks (port
of ``FileBatch`` and ``LeafBatch`` from ``phonic_tpu/graph/batching.py``).

Homogeneous FileSources (same loop kind, endlessness, resampling quality,
channel layout, fade flags and length bucket) render as one bank of lanes:
stacked buffers, a leading lane dimension on every per-source tensor, and
one batched read: the ramp-read kernel (ops/rampread.py) at the default
quality, the polyphase sinc (ops/resample.sinc_read) at "high".
Per-source positions, fades, loop bounds and stop/kill frames are
tensors, so any of them may change between blocks.

The JAX package vmaps a one-lane function over the bank; here the lane
dimension is written out: positions and parameters are ``[S, n]``.

A bank built with ``lanes=L`` holds L independent instances of its
sources (lane-major: row ``l * S + i`` is source i of instance l), for the
lane-batched programs of ``parallel/mesh.py``: the buffers and the read
table are not repeated, only the read map, the per-lane metadata and the
running state.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from ..ops import rampread
from ..ops import resample as rs
from ..ops.buffer import remap_channels
from ..ops.convert import panning_factors
from ..ops.precision import ds_add
from ..sources.file import FileSource, _host_fade_log1m
from .nodes import global_frames


def group_key(src: FileSource):
    """Sources with equal keys share one lane bank."""
    return (
        "file",
        src.buffer.channels,
        src.buffer.sample_rate,
        "none" if src.loop_range is None else src.loop_mode,
        src.options.repeat is None,
        src.options.resampling_quality,
        src.options.fade_in_secs > 0.0,
        src.options.fade_out_secs > 0.0,
        # every lane zero-pads to the group's longest buffer
        rs.length_bucket(src.buffer.frames),
    )


class FileBatch:
    """Static per-group data (on the program's device) + the renderer."""

    def __init__(self, sources: list[FileSource], paths: list[str], ctx,
                 lanes: int = 1):
        self.sources = sources
        self.paths = paths
        self.ctx = ctx
        self.lanes = lanes
        s0 = sources[0]
        self.loop_kind = "none" if s0.loop_range is None else s0.loop_mode
        self.endless = s0.options.repeat is None
        self.channels_in = s0.buffer.channels
        self.has_fade_in = s0.options.fade_in_secs > 0.0
        self.has_fade_out = s0.options.fade_out_secs > 0.0

        dev = ctx.device
        fmax = max(s.buffer.frames for s in sources)
        bufs = np.zeros((len(sources), self.channels_in, fmax + 1), np.float32)
        for i, s in enumerate(sources):
            bufs[i, :, : s.buffer.frames + 1] = np.asarray(s.buffer.data)
        sr = ctx.sample_rate
        self.buffers = torch.as_tensor(bufs, device=dev)
        self.smap = torch.arange(len(sources), dtype=torch.int32,
                                 device=dev).repeat(lanes)

        def lane(fn, dtype):
            """Per-lane metadata as [L*S, 1], to broadcast against
            [L*S, n]."""
            return torch.tensor([[fn(s)] for s in sources] * lanes,
                                dtype=dtype, device=dev)

        def fade(secs):
            return _host_fade_log1m(secs, sr) if secs > 0 else 0.0

        i32, f32 = torch.int32, torch.float32
        self.frames = lane(lambda s: s.buffer.frames, i32)
        self.start_time = lane(lambda s: s.options.start_time, torch.int64)
        self.repeat = lane(lambda s: s.options.repeat or 0, i32)
        self.loop_start = lane(
            lambda s: 0 if s.loop_range is None else int(s.loop_range[0]), i32)
        self.loop_end = lane(
            lambda s: 1 if s.loop_range is None else int(s.loop_range[1]), i32)
        self.ratio = lane(lambda s: s.buffer.sample_rate / sr, f32)
        self.fade_in_log1m = lane(lambda s: fade(s.options.fade_in_secs), f32)
        self.fade_out_log1m = lane(lambda s: fade(s.options.fade_out_secs), f32)
        self.sinc = None
        if s0.options.resampling_quality == "high":
            # one table per bank, its cutoff set by the fastest lane's
            # initial step (a float32 product, as the JAX package's bank)
            max_r = max(float(np.float32(s.buffer.sample_rate / sr)
                              * np.float32(s.options.speed)) for s in sources)
            self.sinc = torch.tensor(
                rs.sinc_table(cutoff=min(1.0, 1.0 / max(max_r, 1.0))),
                device=dev)

    def init_state(self):
        """Running state: the compensated position ``base + frac + frac_lo``
        per lane."""
        s, dev = len(self.sources) * self.lanes, self.ctx.device
        return {
            "base": torch.zeros(s, dtype=torch.int32, device=dev),
            "frac": torch.zeros(s, dtype=torch.float32, device=dev),
            "frac_lo": torch.zeros(s, dtype=torch.float32, device=dev),
        }

    def shard(self, members, device) -> "FileBatch":
        """The bank's sources ``members`` (every instance of each) as a
        bank of their own on ``device``, for a bank split over devices
        (``parallel/mesh.GraphShardedProgram``): its buffers and per-lane
        metadata are this bank's rows, and its step bound and sinc table
        stay this bank's, so each row renders as it does here."""
        view = copy.copy(self)
        view.ctx = self.ctx._replace(device=device)
        rows = torch.as_tensor(member_rows(members, len(self.sources),
                                           self.lanes), device=self.ctx.device)
        for k in ("frames", "start_time", "repeat", "loop_start", "loop_end",
                  "ratio", "fade_in_log1m", "fade_out_log1m"):
            setattr(view, k, getattr(self, k)[rows].to(device))
        idx = torch.as_tensor(members, device=self.ctx.device)
        view.buffers = self.buffers[idx].to(device)
        view.smap = torch.arange(len(members), dtype=torch.int32,
                                 device=device).repeat(self.lanes)
        view.sinc = None if self.sinc is None else self.sinc.to(device)
        view.paths = [self.paths[i] for i in members]
        return view

    def _fold(self, ki, fr):
        """Linear source position (int frames ki + frac fr) -> buffer
        position + live mask (reference loop semantics:
        src/source/file/preloaded.rs:270-332)."""
        frames, rpt = self.frames, self.repeat
        lstart, lend = self.loop_start, self.loop_end
        if self.loop_kind != "none":
            length = torch.clamp(lend - lstart, min=1)
            rel = ki - lstart
            if self.loop_kind == "pingpong":
                c = torch.remainder(rel, 2 * length)
                fwd = c < length
                fki = torch.where(fwd, lstart + c, lstart + 2 * length - c - 1)
                ffr = torch.where(fwd, fr, 1.0 - fr)
            else:
                fki = lstart + torch.remainder(rel, length)
                ffr = fr
            in_loop = ki >= lstart
            if self.endless:
                return (torch.where(in_loop, fki, ki),
                        torch.where(in_loop, ffr, fr),
                        torch.ones_like(ki, dtype=torch.bool))
            span = lstart + (rpt + 1) * length
            after_ki = ki - rpt * length  # continue past the loop to file end
            fki = torch.where(ki < span, torch.where(in_loop, fki, ki), after_ki)
            ffr = torch.where(ki < span, torch.where(in_loop, ffr, fr), fr)
            return fki, ffr, ki < frames + rpt * length
        if self.endless:
            return (torch.remainder(ki, frames), fr,
                    torch.ones_like(ki, dtype=torch.bool))
        p = torch.where(rpt > 0, torch.remainder(ki, frames), ki)
        return p, fr, ki < frames * (rpt + 1)

    def _fold_state(self, base):
        """Keep the carried position bounded for endless playback."""
        if not self.endless:
            return base
        frames = self.frames[:, 0]
        if self.loop_kind != "none":
            lstart, lend = self.loop_start[:, 0], self.loop_end[:, 0]
            length = torch.clamp(lend - lstart, min=1)
            period = 2 * length if self.loop_kind == "pingpong" else length
            return torch.where(base >= lstart,
                               lstart + torch.remainder(base - lstart, period),
                               base)
        return torch.remainder(base, frames)

    def lane_pos(self, state, frame0, speed, kill_at, seek_flag,
                 seek_pos, smax: float):
        """Per-lane read positions ``[S, n]``, the activity mask and the
        next block's position state.  ``frame0``: the block's start frame,
        a host int, or each lane's as an int64 tensor [S]."""
        n = self.ctx.block_frames
        dev = self.ctx.device
        gframes = global_frames(frame0, n, dev)
        active = (gframes >= self.start_time) & (gframes < kill_at[:, None])

        seek = seek_flag > 0.5
        seek_int = torch.floor(seek_pos)
        base0 = torch.where(seek, seek_int.to(torch.int32), state["base"])
        frac0 = torch.where(seek, seek_pos - seek_int, state["frac"])
        lo0 = torch.where(seek, 0.0, state["frac_lo"])

        steps = torch.where(active, speed * self.ratio, 0.0)
        # the JAX package's windowed reads clamp steps to smax (2**bucket of
        # the max speed ever scheduled, so this never binds in contract);
        # clamping here too keeps the positions identical to it
        steps = torch.clamp(steps, max=smax)
        # positions as affine base + residual cumsum: exact for constant
        # speed, and the residual is tiny during glides
        s0 = steps[:, -1:]
        resid = torch.cumsum(steps - s0, dim=-1)
        rel = s0 * torch.arange(n, dtype=torch.float32, device=dev) + torch.cat(
            [torch.zeros_like(resid[:, :1]), resid[:, :-1]], dim=-1)
        p = frac0[:, None] + (rel + lo0[:, None])
        ip = torch.floor(p)
        fr = p - ip
        ki = base0[:, None] + ip.to(torch.int32)

        fki, ffr, live = self._fold(ki, fr)
        mask = (active & live).to(torch.float32)
        pos = fki.to(torch.float32) + ffr

        advance = s0[:, 0] * np.float32(n) + resid[:, -1]
        total, lo_new = ds_add(frac0, lo0, advance)
        carry = torch.floor(total)
        new_base = self._fold_state(base0 + carry.to(torch.int32))
        # subtracting the integer part is exact, so lo carries over unchanged
        return pos, mask, {"base": new_base, "frac": total - carry,
                           "frac_lo": lo_new}

    def lane_post(self, audio, mask, frame0, volume, panning, stop_at):
        """Mask, channel remap, volume with fades, and pan: [S, ch, n]."""
        ctx = self.ctx
        n = ctx.block_frames
        gframes = global_frames(frame0, n, ctx.device)
        audio = remap_channels(audio * mask[:, None, :], ctx.channels)
        gain = volume
        if self.has_fade_in:
            k_in = (gframes - self.start_time + 1).to(torch.float32)
            up = 1.0 - torch.exp(self.fade_in_log1m * torch.clamp(k_in, min=0.0))
            gain = gain * torch.where(
                k_in > 0, torch.where(up > 1.0 - 1e-4, 1.0, up), 0.0)
        k_out = (gframes - stop_at[:, None] + 1).to(torch.float32)
        if self.has_fade_out:
            down = torch.exp(self.fade_out_log1m * torch.clamp(k_out, min=0.0))
            gain = gain * torch.where(
                k_out > 0, torch.where(down < 1e-4, 0.0, down), 1.0)
        else:
            gain = gain * (gframes < stop_at[:, None])
        audio = audio * gain[:, None, :]
        if ctx.channels >= 2:
            left, right = panning_factors(panning)
            audio = torch.cat([audio[:, :1] * left[:, None],
                               audio[:, 1:2] * right[:, None], audio[:, 2:]],
                              dim=1)
        return audio

    def render(self, state, frame0, volume, panning, speed, stop_at,
               kill_at, seek_flag, seek_pos, speeds_differ: bool = False):
        """Parameters ``[S, n]``; stop/kill frames and seeks ``[S]``;
        ``frame0`` a host int or each lane's start frame ``[S]``.
        ``speeds_differ``: the instances' speeds come from their own
        schedules, not the bank's sources' (a lane-batched program's
        per-lane inputs), so the step bound is the largest bucket's: like
        each instance's own bound, it clamps only steps above it.
        Returns (new_state, out [S, ch, n])."""
        n = self.ctx.block_frames
        smax = 2.0 ** (rs.MAX_SPEED_BUCKET if speeds_differ else max(
            s.speed_bucket(self.ctx.sample_rate) for s in self.sources))
        pos, mask, new_state = self.lane_pos(state, frame0, speed, kill_at,
                                             seek_flag, seek_pos, smax)
        if self.sinc is not None:
            # the instances' positions [L, S, n] over the bank's buffers
            audio = rs.sinc_read(
                self.buffers.expand((self.lanes,) + self.buffers.shape),
                pos.view(self.lanes, -1, n), self.sinc).flatten(0, 1)
        else:
            audio = rampread.ramp_read(self.buffers, self.smap, pos)
        return new_state, self.lane_post(audio, mask, frame0, volume,
                                         panning, stop_at)


def member_rows(members, size: int, lanes: int) -> np.ndarray:
    """The rows of a bank of ``size`` members and ``lanes`` instances
    (lane-major: row ``l * size + i``) that hold ``members``, in order."""
    return (np.arange(lanes)[:, None] * size
            + np.asarray(members)[None, :]).reshape(-1)


def stack_states(states: list):
    """Stack per-lane states (dicts / NamedTuples of tensors) along a new
    leading dimension."""
    s0 = states[0]
    if isinstance(s0, torch.Tensor):
        return torch.stack(states)
    if isinstance(s0, dict):
        return {k: stack_states([s[k] for s in states]) for k in s0}
    return type(s0)(*(stack_states(list(xs)) for xs in zip(*states)))


class LeafBatch:
    """A lane bank of leaf nodes (port of ``LeafBatch`` from
    ``phonic_tpu/graph/batching.py``): nodes with equal
    ``source_batch_key`` render as one call over a leading lane dimension
    G.  A node without a key (a granular sampler, a synth generator, an
    empty node) is a bank of its own.

    Samplers (a generator pool) render through ``process`` with their
    voices as lanes [G, V], or ``process_granular``.  Each sampler's read
    source (``read_table``: its buffer, or the granular mono buffer extended
    for the circular taps) is one row of the pool's table, zero-padded to
    the longest (a sampled buffer's live length rides in as
    ``_buf_frames``); ``smap`` maps each read lane (a voice, or a grain
    slot) to its sampler's row, so the whole pool reads in one
    ``ramp_read`` per block.

    Every other node renders through its ``render_lanes``: synth sources,
    streamed sources, synth generators and the empty nodes.  Per-lane
    static config that may differ inside a bank (start times, synth
    frequencies) comes from the node's ``source_batch_statics`` and rides
    in the bank's state under ``_statics``, as in the JAX package.

    The block's lowered inputs go to the device as one array
    (:meth:`stack`).

    With ``lanes=L`` the bank holds L independent instances of its nodes
    (lane-major, as :class:`FileBatch`): the state, the statics and the
    read map have L*G rows, and the read table is not repeated.  Shared
    inputs, the same for every instance, lower one instance's arrays,
    copied to the device once and repeated there (:meth:`voices`);
    per-lane inputs stack every lane's own, ``[L*G, ...]``, with the step
    bound and the live segments the largest over the lanes.  Every pool
    reads all its instances in one ``ramp_read`` per block."""

    def __init__(self, nodes: list, paths: list[str], ctx, lanes: int = 1):
        self.nodes = nodes
        self.paths = paths
        self.ctx = ctx
        self.lanes = lanes
        self.proto = nodes[0]
        dev = ctx.device
        self.table = self.smap = None
        if hasattr(self.proto, "read_table"):
            rows, lanes = zip(*(s.read_table(ctx.sample_rate) for s in nodes))
            table = np.zeros((len(nodes), rows[0].shape[0],
                              max(r.shape[-1] for r in rows)), np.float32)
            for i, r in enumerate(rows):
                table[i, :, : r.shape[-1]] = r
            self.table = torch.as_tensor(table, device=dev)
            self.read_lanes = lanes  # each node's read lanes
            self.smap = self._read_map(len(nodes), lanes, dev)
        rows = [getattr(s, "source_batch_statics", lambda c: {})(ctx)
                for s in nodes] * self.lanes
        self.statics = {k: torch.as_tensor(np.stack([r[k] for r in rows]),
                                           device=dev) for k in rows[0]}

    def _read_map(self, count: int, read_lanes, dev) -> torch.Tensor:
        """Each read lane's row of the table: node i's lanes read row i,
        for every instance."""
        return torch.repeat_interleave(
            torch.arange(count, dtype=torch.int32, device=dev),
            torch.tensor(read_lanes, device=dev),
            output_size=sum(read_lanes)).repeat(self.lanes)

    def shard(self, members, device) -> "LeafBatch":
        """The bank's nodes ``members`` (every instance of each) as a bank
        of their own on ``device``, for a bank split over devices
        (``parallel/mesh.GraphShardedProgram``): their table rows, read map
        and statics.  The block's lowered arrays reach it sliced to its
        rows, with the whole bank's step bound and live segments."""
        view = copy.copy(self)
        view.nodes = [self.nodes[i] for i in members]
        view.paths = [self.paths[i] for i in members]
        view.ctx = self.ctx._replace(device=device)
        if self.table is not None:
            idx = torch.as_tensor(members, device=self.ctx.device)
            view.table = self.table[idx].to(device)
            view.read_lanes = tuple(self.read_lanes[i] for i in members)
            view.smap = view._read_map(len(members), view.read_lanes, device)
        rows = torch.as_tensor(member_rows(members, len(self.nodes),
                                           self.lanes), device=self.ctx.device)
        view.statics = {k: v[rows].to(device) for k, v in self.statics.items()}
        return view

    def init_state(self):
        """Each node's state, stacked: [L*G, ...] (a sampler's
        [L*G, V, ...]), and the lanes' statics under ``_statics``."""
        st = stack_states([s.init_state(self.ctx) for s in self.nodes]
                          * self.lanes)
        if self.statics:
            st["_statics"] = dict(self.statics)
        return st

    def stack(self, lowered: list[dict]):
        """The nodes' lowered inputs (one dict each) -> (one flat int32 host
        array, or None when nothing is lowered, its layout, the pool's step
        bound, the live segments of each automation knot array).

        Every array is stacked over the nodes; a node that lacks an
        optional one (per-note automation knots, loop bounds) gets its
        identity (knots and trigger slots past the block, zeros), and
        arrays whose sizes differ between the nodes (a generator's trigger
        slots) are padded with it to the largest.  The int32 and float32
        arrays pack into one int32 array, float32 values by their bits, so
        the bank's inputs reach the device in one copy and split there
        (:meth:`voices`)."""
        n = self.ctx.block_frames
        smax = max((float(d["_smax"]) for d in lowered if "_smax" in d),
                   default=None)
        stacked, live = {}, {}
        for k in sorted(set().union(*lowered) - {"_smax"}):
            have = [np.asarray(d[k]) for d in lowered if k in d]
            shape = tuple(np.max([a.shape for a in have], axis=0))
            fill = n if k.endswith(("_t", "_time")) else 0
            ident = np.full(shape, fill, have[0].dtype)

            def padded(a):
                a = np.asarray(a, ident.dtype)
                if a.shape == shape:
                    return a
                return np.pad(a, [(0, m - s) for s, m in zip(a.shape, shape)],
                              constant_values=fill)
            a = np.stack([padded(d.get(k, ident)) for d in lowered])
            if a.dtype not in (np.int32, np.float32):
                raise TypeError(f"{k}: lowered as {a.dtype}")
            stacked[k] = a
            if k.endswith("_t"):
                live[k] = 1 + int((a < n).sum(axis=-1).max(initial=0))
        flat = (np.concatenate([a.reshape(-1).view(np.int32)
                                for a in stacked.values()])
                if stacked else None)
        layout = tuple((k, a.shape, a.dtype == np.float32)
                       for k, a in stacked.items())
        return flat, layout, smax, live

    def voices(self, flat, layout) -> dict:
        """The flat int32 tensor of :meth:`stack` on the device -> the
        lowered arrays, as views of it: one instance's ([G, ...] each),
        repeated over the bank's instances ([L*G, ...]) when it holds
        several, or every instance's own when the block's inputs are per
        lane (``[L*G, ...]`` already)."""
        out, off = {}, 0
        for k, shape, is_float in layout:
            size = int(np.prod(shape))
            t = flat[off:off + size].view(shape)
            t = t.view(torch.float32) if is_float else t
            out[k] = (t if self.lanes == 1 or shape[0] != len(self.nodes)
                      else t.repeat((self.lanes,) + (1,) * (t.dim() - 1)))
            off += size
        return out

    def read(self, positions):
        """Every voice lane's read: [L*G*V, n] -> [L*G*V, ch, n]."""
        return rampread.ramp_read(self.table, self.smap, positions)

    def render(self, state, params, voices: dict, smax, live: dict,
               frame0):
        """params: each node parameter [G, n]; voices, smax, live: the
        block's lowered arrays on the device and the host values of
        :meth:`stack`; frame0: the block's global start frame, a host int,
        or each lane's as an int64 tensor [G].  Returns (new state, out
        [G, ch, n])."""
        if self.table is None:
            st = dict(state)
            statics = st.pop("_statics", {})
            new, out = self.proto.render_lanes(st, params, {**voices, **statics},
                                               live, frame0, self.ctx)
            if statics:
                new = dict(new, _statics=statics)
            return new, out
        if self.proto.granular is not None:
            return self.proto.process_granular(state, params, voices, smax,
                                               frame0, self.read, self.ctx)
        return self.proto.process(state, params, voices, smax, live,
                                  self.read, self.ctx)


SamplerBatch = LeafBatch  # the JAX package's earlier name for it
