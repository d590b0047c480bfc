"""Streamed file playback: O(window) device memory for arbitrarily long
files (port of ``phonic_tpu/sources/streamed.py``).

Behavioural spec: reference src/source/file/streamed.rs — a dedicated decoder
thread feeds a 128 Ki-sample SPSC ring; the audio thread resamples from the
ring with zero-padding at EOF; seek restarts the decoder.

The *host* is the decoder/feeder.  Per block it assembles a fixed-size
window of the next W source frames **in playback order** (loop folding,
repeats and seeks all applied host-side with cheap gathers) and ships it as
a block input; the device reads the window with the same Hermite
interpolation as the preloaded source at positions that are a pure cumsum
of the speed timeline.  The device carries no position state — the host
timeline (a copy of the JAX package's) is authoritative, so this source is
trivially checkpoint/resume and scrub safe.

Host memory is O(window) too: the window gathers through a chunked
incremental decoder (io/chunked.py) whose bounded LRU is the analog of the
reference's 128 Ki-sample decode ring (streamed.rs:522-567).  Passing an
in-memory AudioFileBuffer keeps the preloaded data; passing a PATH streams
from disk.

The window is sized for a speed cap: W = block * ratio * speed_cap +
margin.  Lowering a block whose scheduled speed exceeds the cap raises
(the JAX package's docstring promises that check, but its code clamps the
speed to the cap instead).  Every streamed source renders as a lane of a
bank (graph/batching.LeafBatch): the block's windows stack in the lowered
inputs, per-lane start times ride in the bank's state as ``_statics``.
"""

from __future__ import annotations

import math
from typing import Optional, Union

import numpy as np
import torch

from ..errors import ParameterError
from ..graph.nodes import BuildCtx, Source, global_frames
from ..io.decoder import AudioFileBuffer
from ..ops import resample as rs
from ..ops.buffer import remap_channels
from ..ops.convert import panning_factors
from ..params import DecibelScaling, FloatParameter, format_gain, format_pan
from .file import NEVER, FilePlaybackOptions, _host_fade_log1m  # noqa: F401

VOLUME = FloatParameter("VOLU", "Volume", 0.0, 4.0, 1.0,
                        scaling=DecibelScaling(-60.0, 12.0), formatter=format_gain)
PANNING = FloatParameter("PANN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)
SPEED = FloatParameter("SPED", "Speed", 0.001, 16.0, 1.0, smoothing=None)

_MARGIN = 8


class StreamedFileSource(Source):
    """Streaming counterpart of FileSource (same options/controls)."""

    PARAMS = (VOLUME, PANNING, SPEED)
    WEIGHT = 1

    def __init__(self, file: Union[str, AudioFileBuffer],
                 options: Optional[FilePlaybackOptions] = None,
                 speed_cap: Optional[float] = None, name=None,
                 chunk_frames: int = 65536, max_chunks: int = 16):
        super().__init__(name)
        self.options = (options or FilePlaybackOptions()).validate()
        from ..io.chunked import BufferReader, CachedReader, open_chunked
        if isinstance(file, AudioFileBuffer):
            # preloaded data: wrap it (no extra copies; the guard frame is
            # dropped — gather() zero-fills outside [0, frames))
            self.reader = CachedReader(
                BufferReader(np.asarray(file.data)[:, :-1], file.sample_rate),
                chunk_frames, max_chunks)
            loop_range, loop_mode = file.loop_range, file.loop_mode
        elif isinstance(file, CachedReader):
            self.reader = file
            loop_range, loop_mode = self._loops_to_range(file.loops)
        else:
            self.reader = open_chunked(file, chunk_frames, max_chunks)
            loop_range, loop_mode = self._loops_to_range(self.reader.loops)
        self.loop_range = self.options.loop_range or loop_range
        self.loop_mode = loop_mode
        self.speed_cap = float(speed_cap or max(self.options.speed * 2.0, 2.0))
        self._seeks: list[tuple[int, float]] = []
        # runtime control messages: (time, kind, value) with kind in
        # {"loop", "repeat"} (reference: StreamedFileSourceMessage::
        # SetLoopRange / SetRepeat, src/source/file/streamed.rs:37-50)
        self._ctrl_msgs: list[tuple[int, str, object]] = []

    @staticmethod
    def _loops_to_range(loops):
        """First smpl loop -> half-open range + mode (mirrors
        AudioFileBuffer.from_file; reference src/source/file/decoder.rs:27-43)."""
        from ..io import wav as wav_io
        if not loops:
            return None, "forward"
        lp = loops[0]
        mode = "pingpong" if lp.mode == wav_io.LOOP_PINGPONG else "forward"
        return (lp.start, lp.end + 1), mode

    def seek(self, at_frame: int, to_source_frame: float):
        self._seeks.append((int(at_frame), float(to_source_frame)))

    def set_loop_range(self, loop_range, time: int = 0):
        """Change or disable looping mid-playback (reference:
        StreamedFileSourceMessage::SetLoopRange).  The source position stays
        continuous across the change; if the current position lies past the
        new loop end it wraps into the new range, like the reference decoder
        whose next wrap check uses the new points."""
        if loop_range is not None:
            start, end = int(loop_range[0]), int(loop_range[1])
            frames = self.reader.frames
            if not (0 <= start < frames and start < end <= frames):
                raise ValueError(
                    f"Invalid loop range {loop_range!r}; must lie in "
                    f"0..{frames}")
            loop_range = (start, end)
        self._ctrl_msgs.append((int(time), "loop", loop_range))

    def set_repeat(self, repeat, time: int = 0):
        """Change the remaining repeat count mid-playback (reference:
        StreamedFileSourceMessage::SetRepeat).  ``repeat`` counts FUTURE
        loop passes from the change point (None = forever)."""
        if repeat is not None and int(repeat) < 0:
            raise ValueError("repeat must be >= 0 or None")
        self._ctrl_msgs.append(
            (int(time), "repeat", None if repeat is None else int(repeat)))

    def handle_message(self, message, time: int = 0):
        """('set_loop_range', range) / ('set_repeat', n) tuples."""
        if isinstance(message, tuple) and len(message) == 2:
            kind, val = message
            if kind == "set_loop_range":
                return self.set_loop_range(val, time=time)
            if kind == "set_repeat":
                return self.set_repeat(val, time=time)
        raise ValueError(f"unknown streamed-source message {message!r}")

    def param_initials(self):
        return {VOLUME.id: self.options.volume, PANNING.id: self.options.panning,
                SPEED.id: self.options.speed}

    # ------------------------------------------------------------------
    # host-side feeder
    # ------------------------------------------------------------------

    def _window_frames(self, ctx: BuildCtx) -> int:
        ratio = self.reader.sample_rate / ctx.sample_rate
        return int(math.ceil(ctx.block_frames * ratio * self.speed_cap)) + _MARGIN

    def _step_integral(self, a: int, b: int, ratio: float) -> float:
        """Source frames the read advances over output frames [a, b) of the
        (stepped) speed timeline: each segment's length times its step, the
        float32 product the device's positions sum (speed capped, times
        the float32 rate ratio), so a block's start on the host continues
        the previous block's positions on the device exactly.  (The JAX
        package integrates in float64 with the float64 ratio, so its block
        starts drift from its float32 in-block steps.)"""
        ratio32 = np.float32(ratio)

        def step(v):
            return float(np.float32(np.float32(min(v, self.speed_cap))
                                    * ratio32))
        tl = getattr(self, "_timelines", {}).get(SPEED.id)
        if tl is None or not tl.times:
            return (b - a) * step(self.options.speed)
        total = 0.0
        cur = a
        for t in tl.times:
            if t <= a or t >= b:
                continue
            total += (t - cur) * step(tl.value_at(t - 1 if t > 0 else 0))
            cur = t
        total += (b - cur) * step(tl.value_at(b - 1))
        return total

    # ------------------------------------------------------------------
    # anchored fold state: virtual position u maps to source frames via
    # rel = u + delta, folded by the CURRENT loop/repeat parameters.  Runtime
    # SetLoopRange / SetRepeat re-anchor delta (and the repeat exit span /
    # live limit, both in rel coordinates) so the source position stays
    # continuous across changes — the piecewise analog of the reference's
    # stateful decoder position.
    # ------------------------------------------------------------------

    def _initial_fold_state(self):
        frames = self.reader.frames
        loop = self.loop_range
        rpt = self.options.repeat
        st = {"delta": 0, "loop": loop, "mode": self.loop_mode,
              "span": math.inf, "after": 0, "live": math.inf, "wrap": False}
        if loop is not None:
            a, b = int(loop[0]), int(loop[1])
            st["loop"] = (a, b)
            if rpt is not None:
                length = max(b - a, 1)
                st["span"] = a + (rpt + 1) * length
                st["after"] = rpt * length
                st["live"] = frames + rpt * length
        else:
            if rpt is None:
                st["wrap"] = True
            elif rpt > 0:
                st["wrap"] = True
                st["live"] = frames * (rpt + 1)
            else:
                st["live"] = frames
        return st

    def _fold_rel(self, rel, st):
        """rel (scalar or array, int) -> (source frames, live mask)."""
        frames = self.reader.frames
        rel = np.asarray(rel)
        live = rel < st["live"]
        loop = st["loop"]
        if loop is None:
            if st["wrap"]:
                return np.mod(rel, frames), live
            return rel, live
        a, b = loop
        length = max(b - a, 1)
        if st["mode"] == "pingpong":
            c = np.mod(rel - a, 2 * length)
            folded = np.where(c < length, a + c, a + 2 * length - c - 1)
        else:
            folded = a + np.mod(rel - a, length)
        src = np.where(rel < st["span"],
                       np.where(rel >= a, folded, rel),
                       rel - st["after"])
        return src, live

    def _apply_ctrl(self, st, cur_rpt, rel1, kind, val):
        """Re-anchor the fold state at rel coordinate ``rel1`` for a runtime
        loop/repeat change; returns (new_state, new_cur_rpt)."""
        frames = self.reader.frames
        s1 = int(self._fold_rel(rel1, st)[0])
        st = dict(st)
        if kind == "repeat":
            cur_rpt = val
        loop = st["loop"] if kind == "repeat" else val
        if kind == "loop":
            if loop is not None:
                a, b = loop
                length = max(b - a, 1)
                if s1 >= b:  # current position past the new end: wrap in
                    s1 = a + (s1 - a) % length
            st["delta"] = st["delta"] + (s1 - rel1)
            rel1 = s1
            st["loop"] = loop
            st["wrap"] = False
        if loop is not None:
            a, b = loop
            length = max(b - a, 1)
            if s1 >= b:
                # the loop already exited into its linear tail (possible for
                # a late SetRepeat): keep the tail mapping, play to the end
                st["span"] = rel1
                st["after"] = rel1 - s1
                st["live"] = rel1 + (frames - s1)
            elif cur_rpt is None:
                st["span"], st["after"], st["live"] = math.inf, 0, math.inf
            else:
                # s1 < b here; rel advances 1:1 with the source until the
                # next wrap, so the distance to it is b - s1
                span = rel1 + (b - s1) + cur_rpt * length
                st["span"] = span
                st["after"] = span - b
                st["live"] = span - b + frames
        else:
            if cur_rpt is None:
                st["wrap"], st["live"] = True, math.inf
            elif cur_rpt > 0:
                st["wrap"] = True
                st["live"] = rel1 + (frames - s1) + cur_rpt * frames
            elif kind == "repeat":
                st["live"] = rel1 + (frames - s1)
        return st, cur_rpt

    def _check_speed_cap(self):
        """Raise when a scheduled speed exceeds the cap the window is sized
        for: the window would run out before the block ends."""
        tl = getattr(self, "_timelines", {}).get(SPEED.id)
        speeds = [self.options.speed]
        if tl is not None:
            speeds += [tl.initial, *tl.values]
        top = max(speeds)
        if top > self.speed_cap:
            raise ParameterError(
                f"StreamedFileSource {self.name!r}: speed {top:g} exceeds its "
                f"speed_cap {self.speed_cap:g}; the decode window is sized "
                f"for the cap, so construct the source with "
                f"speed_cap >= {top:g}")

    def prepare(self, ctx) -> None:
        # the engine calls this at program build, BEFORE any lowering: the
        # window size and feeder rate must never fall back to a default rate
        self._sr = ctx.sample_rate
        self._window_frames_cached = self._window_frames(ctx)

    def lower_block_inputs(self, block_start: int, block_len: int):
        if not hasattr(self, "_sr"):
            raise RuntimeError(
                "StreamedFileSource lowered before prepare(); the node must "
                "be part of a RenderProgram")
        self._check_speed_cap()
        ctx_sr = self._sr
        ratio = self.reader.sample_rate / ctx_sr
        w = self._window_frames_cached

        # authoritative virtual position at block start: integral of the
        # speed timeline since start_time, plus seeks and runtime
        # loop/repeat changes (walked in time order; pure per block)
        start = self.options.start_time
        cur = start
        pos = 0.0
        st = self._initial_fold_state()
        cur_rpt = self.options.repeat
        events = sorted(
            [(t, "seek", p) for t, p in self._seeks]
            + list(self._ctrl_msgs), key=lambda e: e[0])
        for at, kind, val in events:
            if at >= block_start:
                continue
            at = max(at, start)
            pos += self._step_integral(cur, at, ratio)
            cur = at
            if kind == "seek":
                pos = val
                if self._ctrl_msgs:
                    # runtime loop/repeat messages survive a seek: rebuild
                    # the fold state at the fresh anchor with the current
                    # repeat budget (without messages the absolute state is
                    # kept unchanged — exact pre-existing seek semantics)
                    st = self._initial_fold_state()
                    st, cur_rpt = self._apply_ctrl(
                        st, cur_rpt, int(math.floor(pos)), "repeat", cur_rpt)
            else:
                rel1 = int(math.floor(pos)) + st["delta"]
                st, cur_rpt = self._apply_ctrl(st, cur_rpt, rel1, kind, val)
        pos += self._step_integral(max(cur, start), max(block_start, start),
                                   ratio)

        base = math.floor(pos)
        # assemble the playback-order window (1 guard frame before for the
        # hermite -1 tap)
        vp = base - 1 + np.arange(w, dtype=np.int64)
        idx, live = self._fold_rel(vp + st["delta"], st)
        # chunked gather: only the touched decode chunks are resident
        # (idx == frames used to hit the preloaded guard zero; gather()
        # zero-fills outside [0, frames) identically)
        win = self.reader.gather(idx)
        win[:, ~live] = 0.0
        # end-of-stream mask in *virtual* frames relative to the window
        return {
            "_win": win,
            "_win_frac": np.float32(pos - base),
            "_win_live": live.astype(np.float32),
        }

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        # mirror FileSource: finite only without endless loops.  Runtime
        # loop/repeat messages make the end dynamic -> report unbounded so
        # callers pass an explicit duration.
        if self._ctrl_msgs:
            return None
        frames = self.reader.frames
        rpt = self.options.repeat
        if rpt is None:
            return None
        if self.loop_range is not None:
            start, end = self.loop_range
            span = frames + rpt * (end - start)
        else:
            span = frames * (rpt + 1)
        # conservative: integrate at the initial speed
        return self.options.start_time + int(
            math.ceil(span / (self.reader.sample_rate / ctx.sample_rate
                              * max(self.options.speed, 1e-6))))

    def init_state(self, ctx: BuildCtx):
        self._sr = ctx.sample_rate
        self._window_frames_cached = self._window_frames(ctx)
        return {}

    def source_batch_key(self, ctx):
        """Homogeneous streamed lanes (same rates / window / speed cap /
        fade shape) render as one bank: the per-block decode windows stack
        in the lowered inputs, per-lane start times ride as statics."""
        if type(self) is not StreamedFileSource:
            return None
        opt = self.options
        return (
            "streamed",
            self.reader.channels,
            self.reader.sample_rate,
            self._window_frames(ctx),
            round(self.speed_cap, 9),
            round(opt.fade_in_secs, 9),
            round(opt.fade_out_secs, 9),
        )

    def source_batch_statics(self, ctx):
        return {"_start_t0": np.int32(self.options.start_time)}

    def render_lanes(self, state, params, inputs, live, frame0,
                     ctx: BuildCtx):
        """Render the G lanes of a bank: params each [G, n]; inputs the
        stacked windows ``_win`` [G, ch, W], ``_win_frac`` [G] and
        ``_win_live`` [G, W], the statics and ``_stop_at`` / ``_kill_at``
        [G]; ``frame0`` a host int or each lane's start frame [G].  Returns (state, audio [G, ch, n])."""
        n = ctx.block_frames
        win = inputs["_win"]
        dev = win.device
        f32 = torch.float32
        gframes = global_frames(frame0, n, dev)  # [n] or [G, n]
        start_t = inputs["_start_t0"].to(torch.int64)[:, None]
        stop_at = inputs["_stop_at"].to(torch.int64)[:, None]
        kill_at = inputs["_kill_at"].to(torch.int64)[:, None]
        ratio = float(np.float32(self.reader.sample_rate / ctx.sample_rate))

        speed = torch.clamp(params[SPEED.id], max=self.speed_cap)
        active = (gframes >= start_t) & (gframes < kill_at)
        steps = torch.where(active, speed * ratio, 0.0)
        s0 = steps[:, -1:]
        resid = torch.cumsum(steps - s0, dim=-1)
        rel = s0 * torch.arange(n, dtype=f32, device=dev) + torch.cat(
            [torch.zeros_like(resid[:, :1]), resid[:, :-1]], dim=-1)
        # window position: +1 for the guard frame at the window start
        pos = inputs["_win_frac"][:, None] + rel + 1.0

        audio = rs.hermite_read(win, pos[:, None, :])  # [G, ch, n]
        # mask samples whose window slot is beyond the stream end
        live_w = inputs["_win_live"]
        slot = torch.clamp(pos.to(torch.int32), 0, live_w.shape[-1] - 1)
        mask = active & (torch.gather(live_w, 1, slot.to(torch.int64)) > 0.5)
        audio = audio * mask.to(f32)[:, None, :]
        audio = remap_channels(audio, ctx.channels)

        gain = params[VOLUME.id] * self._fade_gains(gframes, stop_at, start_t,
                                                    ctx)
        audio = audio * gain[:, None, :]
        if ctx.channels >= 2:
            left, right = panning_factors(params[PANNING.id])
            audio = torch.cat([audio[:, :1] * left[:, None],
                               audio[:, 1:2] * right[:, None], audio[:, 2:]],
                              dim=1)
        return state, audio

    def _fade_gains(self, gframes, stop_at, start_t, ctx: BuildCtx):
        gain = torch.ones(stop_at.shape[:1] + gframes.shape[-1:],
                          dtype=torch.float32, device=gframes.device)
        if self.options.fade_in_secs > 0.0:
            k = (gframes - start_t + 1).to(torch.float32)
            log1m = _host_fade_log1m(self.options.fade_in_secs, ctx.sample_rate)
            up = 1.0 - torch.exp(log1m * torch.clamp(k, min=0.0))
            gain = gain * torch.where(k > 0, torch.where(up > 1.0 - 1e-4, 1.0,
                                                         up), 0.0)
        if self.options.fade_out_secs > 0.0:
            k = (gframes - stop_at + 1).to(torch.float32)
            log1m = _host_fade_log1m(self.options.fade_out_secs,
                                     ctx.sample_rate)
            down = torch.exp(log1m * torch.clamp(k, min=0.0))
            gain = gain * torch.where(k > 0, torch.where(down < 1e-4, 0.0,
                                                         down), 1.0)
        else:
            gain = gain * (gframes < stop_at)
        return gain
