"""One-shot synth tone source + the SynthDef voice protocol (port of
``phonic_tpu/sources/synth.py``).

Behavioural spec: reference src/source/synth.rs (SynthPlaybackOptions
:27-61, stop message), src/source/synth/common.rs (generator trait + fades
and status handling) and src/source/synth/fundsp.rs (FunDSP-unit-driven
source).

The analog of a FunDSP AudioUnit is a **SynthDef**: a pure-function voice
with an explicit state.  Unlike the JAX package, whose SynthDef renders ONE
voice and is vmapped over voices and lanes, the port's SynthDef renders a
batch of B voices at once, so a recursive filter inside it runs all of them
in one kernel launch (a hand-written kernel has no vmap rule):

    init(ctx, batch)                 -> state, every leaf [batch, ...]
    render(state, SynthContext)      -> (state, audio [B, n] or [B, ch, n])

``SynthContext`` carries ``freq``, ``gate``, ``age`` and ``release_age`` as
``[B, n]`` tensors and ``velocity`` as ``[B, 1]`` (a source) or ``[B, n]``
(a generator's voices); user parameters arrive as ``[n]`` (a generator's,
shared by its voices) or ``[B, n]`` (a bank of sources), modulation outputs
as ``[B, n]``.  See ``phonic_tpu_torch.synths`` for dx7 / organ / sub3.

Every SynthSource renders as a lane of a bank (graph/batching.LeafBatch):
sources that share one SynthDef object and fade shape render in one call,
their start times, gate lengths, frequencies and velocities riding in the
bank's state as ``_statics``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..errors import ParameterError
from ..graph.nodes import BuildCtx, Source
from ..ops.buffer import remap_channels
from ..ops.convert import panning_factors
from ..params import DecibelScaling, FloatParameter, format_gain, format_pan
from .file import _host_fade_log1m

NEVER = np.iinfo(np.int32).max

VOLUME = FloatParameter("VOLU", "Volume", 0.0, 4.0, 1.0,
                        scaling=DecibelScaling(-60.0, 12.0), formatter=format_gain)
PANNING = FloatParameter("PANN", "Panning", -1.0, 1.0, 0.0, formatter=format_pan)


class SynthContext(NamedTuple):
    """Per-block context of B voices handed to SynthDef.render."""

    freq: torch.Tensor  # f32 [B, n] Hz
    gate: torch.Tensor  # f32 [B, n] 1 while held, 0 after release
    velocity: torch.Tensor  # f32 [B, 1] or [B, n]
    age: torch.Tensor  # int [B, n] samples since note start (may be negative)
    release_age: torch.Tensor  # f32 [B, n]: age at note-off (inf = held)
    sample_rate: int
    block_frames: int
    # user-declared FourCC parameters (SynthDef.params): engine-smoothed
    # per-sample arrays, [n] or [B, n] (reference: fundsp Shared vars per
    # voice, src/generator/fundsp/parameter.rs:1-123)
    params: dict = {}
    # per-voice modulation matrix outputs per target parameter id, [B, n]
    # in the matrix's output range (src/generator/fundsp/modulation.rs)
    mods: dict = {}


@dataclasses.dataclass
class SynthDef:
    """A pure-function synth voice bank (the FunDSP AudioUnit analog).

    ``params`` declares user FourCC parameters (reference: the FunDSP
    generator's shared parameters, src/generator/fundsp.rs:88-99): they
    become engine-smoothed per-block arrays in ``SynthContext.params``,
    settable at runtime and routable as modulation targets
    (SynthGenerator.with_modulation)."""

    init: Callable[[BuildCtx, int], dict]
    render: Callable[[dict, SynthContext], tuple]
    channels: int = 1
    params: tuple = ()


@dataclasses.dataclass
class SynthPlaybackOptions:
    """reference: src/source/synth.rs:27-75."""

    volume: float = 1.0
    panning: float = 0.0
    start_time: int = 0
    duration: Optional[int] = None  # output frames of gate-on; None = until stop
    fade_in_secs: float = 0.0
    fade_out_secs: float = 0.05
    frequency: float = 440.0
    velocity: float = 1.0
    # seconds between Position status events (None = positions never
    # emitted); reference default 1 s (src/source/synth.rs:46-51)
    playback_pos_emit_rate: Optional[float] = 1.0
    # enable the per-source CPU-load probe (src/source/synth.rs:58-61)
    measure_cpu_load: bool = False

    def validate(self):
        """reference: SynthPlaybackOptions::validate, synth.rs:128-143."""
        if not (self.volume >= 0.0):  # also catches NaN
            raise ParameterError(f"playback options 'volume' value is {self.volume!r}")
        if not (-1.0 <= self.panning <= 1.0):
            raise ParameterError(f"playback options 'panning' value is {self.panning!r}")
        return self


class SynthSource(Source):
    """Plays one SynthDef voice as a plain source (play_synth path)."""

    PARAMS = (VOLUME, PANNING)
    WEIGHT = 2
    # adopt() carries the synth's own state across topology rebuilds
    BATCH_CARRY = ("synth",)

    def __init__(self, synth: SynthDef,
                 options: Optional[SynthPlaybackOptions] = None, name=None):
        super().__init__(name)
        self.synth = synth
        self.options = (options or SynthPlaybackOptions()).validate()
        # user-declared FourCC parameters become engine-smoothed inputs
        self.PARAMS = SynthSource.PARAMS + tuple(synth.params)

    def param_initials(self):
        out = {VOLUME.id: self.options.volume, PANNING.id: self.options.panning}
        for p in self.synth.params:
            out[p.id] = p.default
        return out

    def source_batch_key(self, ctx):
        """SynthSources that share the SAME SynthDef object and fade shape
        render as one bank; per-lane start / duration / frequency /
        velocity ride in as statics."""
        if type(self) is not SynthSource:
            return None
        return ("synth", id(self.synth),
                round(self.options.fade_in_secs, 9),
                round(self.options.fade_out_secs, 9))

    def source_batch_statics(self, ctx):
        opt = self.options
        return {
            "_start_t0": np.int32(opt.start_time),
            "_gate_dur": np.int32(NEVER if opt.duration is None
                                  else opt.duration),
            "_freq0": np.float32(opt.frequency),
            "_vel0": np.float32(opt.velocity),
        }

    def init_state(self, ctx: BuildCtx):
        """One lane's state: the SynthDef's state of a batch of one, without
        the batch dimension (a bank stacks its lanes' states)."""
        one = self.synth.init(ctx, 1)
        from ..graph.engine import tree_map
        return {"synth": tree_map(lambda a: a[0], one)}

    def duration_frames(self, ctx: BuildCtx) -> Optional[int]:
        if self.options.duration is None:
            return None
        fade = int(self.options.fade_out_secs * ctx.sample_rate) + 1
        return self.options.start_time + self.options.duration + fade

    def render_lanes(self, state, params, inputs, live, frame0: int,
                     ctx: BuildCtx):
        """Render the G lanes of a bank: params each [G, n]; inputs the
        lanes' statics and ``_stop_at`` [G].  Returns (new state, audio
        [G, ch, n])."""
        n = ctx.block_frames
        dev = inputs["_stop_at"].device
        opt = self.options
        gframes = frame0 + torch.arange(n, dtype=torch.int64, device=dev)
        start_t = inputs["_start_t0"].to(torch.int64)[:, None]
        dur = inputs["_gate_dur"].to(torch.int64)[:, None]
        stop_at = inputs["_stop_at"].to(torch.int64)[:, None]
        age = gframes - start_t  # [G, n]
        gate_end = torch.minimum(
            torch.where(dur >= NEVER, NEVER, start_t + dur), stop_at)  # [G, 1]
        gate = ((gframes >= start_t) & (gframes < gate_end)).to(torch.float32)

        sctx = SynthContext(
            freq=inputs["_freq0"][:, None].expand(-1, n),
            gate=gate,
            velocity=inputs["_vel0"][:, None],
            age=age,
            release_age=(gate_end - start_t).to(torch.float32).expand(-1, n),
            sample_rate=ctx.sample_rate,
            block_frames=n,
            params={p.id: params[p.id] for p in self.synth.params},
        )
        synth_state, audio = self.synth.render(state["synth"], sctx)
        if audio.dim() == 2:
            audio = audio[:, None, :]
        audio = remap_channels(audio, ctx.channels)
        gain = (age >= 0).to(torch.float32)

        # analytic exponential fade-in from start (synth.rs:41-44 fade_in
        # option; exponential fader semantics, src/utils/fader.rs:76-121)
        if opt.fade_in_secs > 0.0:
            k_in = (age + 1).to(torch.float32)
            log1m_in = _host_fade_log1m(opt.fade_in_secs, ctx.sample_rate)
            up = 1.0 - torch.exp(log1m_in * torch.clamp(k_in, min=0.0))
            gain = gain * torch.where(
                k_in > 0, torch.where(up > 1.0 - 1e-4, 1.0, up), 0.0)

        # de-click fade after the gate closes (the SynthDef's own envelope
        # normally handles the decay; this guards non-enveloped defs)
        k = (gframes - gate_end + 1).to(torch.float32)
        log1m = math.log1p(-(1.0 - math.exp(
            -1.0 / max(ctx.sample_rate * opt.fade_out_secs / math.log(100.0),
                       1e-9))))
        down = torch.exp(log1m * torch.clamp(k, min=0.0))
        gain = gain * torch.where(k > 0, torch.where(down < 1e-4, 0.0, down),
                                  1.0)
        audio = audio * gain[:, None, :]
        audio = audio * params[VOLUME.id][:, None, :]
        if ctx.channels >= 2:
            left, right = panning_factors(params[PANNING.id])
            audio = torch.cat([audio[:, :1] * left[:, None],
                               audio[:, 1:2] * right[:, None], audio[:, 2:]],
                              dim=1)
        return {"synth": synth_state}, audio
