"""Example SynthDefs (port of ``phonic_tpu/synths/__init__.py``), mirroring
the reference's demo instruments (reference:
examples/common/synths/{organ,sub3,dx7}.rs — behavioural inspiration only).

They keep the JAX package's names, arguments, FourCC parameters and
defaults, written on the port's batched SynthDef protocol
(sources/synth.py): each renders a bank of B voices at once, and sub3's
resonant SVF runs all of them through one ``ops/filters.tpt_process``, one
iir2 launch of B rows on the card.  sub3 also describes its voice
(``SynthDef.kernel``): a SynthGenerator renders it through kernels 10, 2
(iir2) and 11 on the card (ops/synthvoice.py).
"""

from __future__ import annotations

import functools

import torch

from ..graph.nodes import BuildCtx
from ..ops import ahdsr as ahdsr_ops
from ..ops import consts, filters, osc
from ..ops.precision import recip32
from ..ops.synthvoice import SubtractiveVoice
from ..params import ExponentialScaling, FloatParameter
from ..sources.synth import SynthContext, SynthDef


@functools.lru_cache(maxsize=256)
def _env_params(sample_rate: int, device: torch.device, *adsr):
    """AHDSR rates of constant stage times, made once per device."""
    p = ahdsr_ops.ahdsr_params(sample_rate, *adsr)
    return ahdsr_ops.AhdsrParams(*(
        consts.const(float(f), torch.float32, device)
        if isinstance(f, torch.Tensor) else f for f in p))


def _env(ctx: SynthContext, attack, hold, decay, sustain, release):
    """Shared AHDSR helper (the analog of utils/fundsp/ahdsr.rs): gate-driven
    envelope from the analytic AHDSR, release at the gate's falling edge."""
    p = _env_params(ctx.sample_rate, ctx.age.device, attack, hold, decay,
                    sustain, release)
    return ahdsr_ops.ahdsr_values(p, 1.0, ctx.age, ctx.release_age)


def _zeros(ctx: BuildCtx, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=ctx.device)


def organ(drawbars=(1.0, 0.6, 0.4, 0.25, 0.15)) -> SynthDef:
    """Additive drawbar organ: stacked sine partials with a soft envelope."""

    def init(ctx: BuildCtx, batch: int):
        return {"phase": _zeros(ctx, batch, len(drawbars))}

    def render(state, ctx: SynthContext):
        total = torch.zeros_like(ctx.freq)
        ends = []
        for k, amp in enumerate(drawbars):
            ph, end = osc.phase_accumulate(state["phase"][:, k],
                                           ctx.freq * float(k + 1),
                                           ctx.sample_rate)
            total = total + amp * osc.sine(ph)
            ends.append(end)
        env = _env(ctx, 0.005, 0.0, 0.0, 1.0, 0.08)
        y = total * recip32(sum(drawbars)) * env
        return {"phase": torch.stack(ends, dim=-1)}, y

    return SynthDef(init=init, render=render, channels=1)


def sub3(shape: float = 2.0, detune_cents: float = 7.0, cutoff: float = 2500.0,
         resonance: float = 0.4) -> SynthDef:
    """3-oscillator subtractive synth: detuned morphing oscillators into a
    resonant SVF lowpass with an AHDSR.

    Declares its core controls as user FourCC parameters (the analog of the
    reference sub3's shared parameters, examples/common/synths/sub3.rs:
    27-80): engine-smoothed, settable via handles, and modulation targets
    for SynthGenerator.with_modulation — modulation offsets arrive in
    ``ctx.mods`` and multiply the cutoff / add to shape."""
    P_SHAPE = FloatParameter("SHAP", "Osc Shape", 0.0, 3.0, shape,
                             smoothing=None)
    P_DETUNE = FloatParameter("DETN", "Detune", 0.0, 50.0, detune_cents,
                              unit="ct", smoothing=None)
    P_CUTOFF = FloatParameter("CUTF", "Cutoff", 20.0, 20000.0, cutoff,
                              unit="Hz", scaling=ExponentialScaling(2.5))
    P_RESO = FloatParameter("RESO", "Resonance", 0.0, 0.95, resonance)
    envelope = (0.01, 0.0, 0.3, 0.6, 0.15)  # amp AHDSR

    def init(ctx: BuildCtx, batch: int):
        return {"phase": _zeros(ctx, batch, 3),
                "svf": filters.tpt_state_init((batch,), device=ctx.device)}

    def render(state, ctx: SynthContext):
        shape_v = ctx.params["SHAP"]
        if "SHAP" in ctx.mods:
            shape_v = shape_v + ctx.mods["SHAP"]
        # float64 exp2 rounded once, the same float32 on the card and on the
        # CPU: the detuned phases run for the voice's whole life
        det = torch.exp2((ctx.params["DETN"] * recip32(1200.0)).to(
            torch.float64)).to(torch.float32)
        cut_p = ctx.params["CUTF"]
        if "CUTF" in ctx.mods:
            cut_p = cut_p * (1.0 + ctx.mods["CUTF"])
        res = ctx.params["RESO"]
        freqs = [ctx.freq, ctx.freq * det, ctx.freq / det]
        mix = torch.zeros_like(ctx.freq)
        ends = []
        for k, f in enumerate(freqs):
            ph, end = osc.phase_accumulate(state["phase"][:, k], f,
                                           ctx.sample_rate)
            mix = mix + osc.morph_osc(ph, shape_v, f, ctx.sample_rate)
            ends.append(end)
        mix = mix * recip32(3.0)
        env = _env(ctx, *envelope)
        # envelope also sweeps the filter cutoff
        cut = torch.clamp(cut_p * (0.2 + 0.8 * env), 20.0,
                          ctx.sample_rate / 2.0)
        coefs = filters.svf_coefficients(filters.LOWPASS, ctx.sample_rate,
                                         cut, res)
        # every voice of the bank in one recurrence: [B, n] rows
        svf, filtered = filters.tpt_process(state["svf"], mix, coefs)
        return ({"phase": torch.stack(ends, dim=-1), "svf": svf},
                filtered * env)

    # a SynthGenerator renders this voice through kernels 10 and 11
    # (ops/synthvoice.py), which compute what ``render`` does
    return SynthDef(init=init, render=render, channels=1,
                    params=(P_SHAPE, P_DETUNE, P_CUTOFF, P_RESO),
                    kernel=SubtractiveVoice(P_SHAPE.id, P_DETUNE.id,
                                            P_CUTOFF.id, P_RESO.id, envelope,
                                            render))


def dx7(ratio: float = 2.0, index: float = 3.0) -> SynthDef:
    """Minimal 2-operator FM voice (DX7-flavoured): a modulator at
    ``ratio`` x the carrier frequency phase-modulates the carrier; the
    modulation index decays faster than the amplitude for the classic
    brightness-then-body attack."""

    def init(ctx: BuildCtx, batch: int):
        return {"phase": _zeros(ctx, batch, 2)}

    def render(state, ctx: SynthContext):
        mod_ph, mod_end = osc.phase_accumulate(
            state["phase"][:, 0], ctx.freq * ratio, ctx.sample_rate)
        car_ph, car_end = osc.phase_accumulate(
            state["phase"][:, 1], ctx.freq, ctx.sample_rate)
        amp_env = _env(ctx, 0.002, 0.0, 0.5, 0.4, 0.2)
        mod_env = _env(ctx, 0.001, 0.0, 0.15, 0.15, 0.1)
        modulator = osc.sine(mod_ph) * index * mod_env * ctx.velocity
        carrier = torch.sin(osc._TWO_PI * car_ph + modulator)
        return {"phase": torch.stack([mod_end, car_end], dim=-1)}, \
            carrier * amp_env

    return SynthDef(init=init, render=render, channels=1)
