"""Synth playback (phonic_tpu_torch/ops/osc.py, sources/synth.py, synths/,
generators/synth.py) against the JAX package on the CPU.

The JAX package sums oscillator phases in float32, the port in float64
rounded once, so the two agree exactly only where the phase increments
are dyadic; elsewhere JAX's own rounding shows (-60..-85 dB at 4096-frame
blocks and mid-range notes; scripts/torch_synth_parity.py).  So:

* the oscillators are held against JAX at dyadic increments (375, 750 and
  1500 Hz at 48 kHz), to 1e-6;
* synth sources render at dyadic frequencies at 48 kHz, sub3 with its
  detune at 0 (exp2(0) = 1);
* synth generators render at a 65536 Hz engine rate, where the float32
  reciprocal of the rate is exact and notes 45 / 57 / 69 / 81 (110 to
  880 Hz, whose float32 frequency the JAX package computes exactly) step
  by dyadic increments; automation and glides run on sine-based synths
  at low notes over 2048-frame blocks.

The port's polyBLEP residual is the standard one, where the JAX package's
runs from 1 to 4 before a wrap (``ops/osc.py``'s known deviation): every
JAX render here runs with the standard residual put in its place
(``jax_polyblep.py``), and the residual itself is held to its definition.

Every render is held to -90 dB of each block's peak.  A JAX state carried
over with ``state_from_jax`` renders the next block as JAX does;
``freq_mult`` is exactly 1 without automation; ``play_synth`` and
``play_generator`` through the port's Player equal the program's render.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import phonic_tpu as jp
import phonic_tpu_torch as pt
from phonic_tpu.ops import osc as josc
from phonic_tpu_torch.convert import state_from_jax
from phonic_tpu_torch.generators.synth import note_speed
from phonic_tpu_torch.ops import osc as posc
from phonic_tpu_torch.ops.precision import recip32
from phonic_tpu_torch.outputs.null import NullOutput
from phonic_tpu_torch.player import (GeneratorPlaybackHandle, PlaybackHandle,
                                     Player, PlayerConfig)
from jax_polyblep import standard_polyblep

SR = 48000
GEN_SR = 65536
BLOCK = 4096
GEN_BLOCK = 2048
DB90 = 10.0 ** (-90.0 / 20.0)


def _package(name):
    """The classes the scenarios use, from ``phonic_tpu`` or the port."""
    names = {"": ("Mixer", "RenderProgram", "EngineConfig", "SynthDef",
                  "SynthPlaybackOptions", "SynthSource", "SynthGenerator",
                  "GeneratorPlaybackOptions", "ModulationConfig",
                  "EnvelopeSource", "VelocitySource"),
             ".params": ("FloatParameter",)}
    ns = {"synths": importlib.import_module(name + ".synths")}
    for mod, attrs in names.items():
        m = importlib.import_module(name + mod)
        ns.update((a, getattr(m, a)) for a in attrs)
    return type(name, (), ns)


JAX = _package("phonic_tpu")
PORT = _package("phonic_tpu_torch")


def _program(pkg, main, sr, block):
    if pkg is JAX:
        return jp.RenderProgram(main, jp.EngineConfig(sample_rate=sr,
                                                      block_frames=block))
    return pt.RenderProgram(main, pt.EngineConfig(
        sample_rate=sr, block_frames=block, device="cpu"))


def _render(pkg, prog, frames):
    return prog.render(frames, mode="loop") if pkg is JAX else prog.render(frames)


def _close(got, want, block, bound=DB90):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    for b in range(got.shape[-1] // block):
        sl = slice(b * block, (b + 1) * block)
        peak = np.abs(want[:, sl]).max()
        assert peak > 0.05
        err = np.abs(got[:, sl] - want[:, sl]).max()
        assert err <= bound * peak, f"block {b}: {20 * np.log10(err / peak):.1f} dB"


# ---------------------------------------------------------------------------
# 1. oscillators
# ---------------------------------------------------------------------------

def test_oscillators_match_jax_at_dyadic_increments():
    """Three voices at 375 / 750 / 1500 Hz (2^-7 .. 2^-5 cycles per
    sample), a carried phase of 0.25: phases bit for bit, every waveshape
    and the morph (fixed and per-sample shape) to 1e-6."""
    n = 2048
    freqs = np.array([375.0, 750.0, 1500.0], np.float32)
    fr = np.repeat(freqs[:, None], n, axis=1)
    ph = torch.tensor(0.25).expand(3)
    got, got_end = posc.phase_accumulate(ph, torch.tensor(fr), SR)
    for v in range(3):
        want, want_end = josc.phase_accumulate(jnp.float32(0.25),
                                               jnp.asarray(fr[v]), SR)
        np.testing.assert_array_equal(got[v].numpy(), np.asarray(want))
        assert float(got_end[v]) == float(want_end)
    shapes = np.linspace(0.0, 3.0, n, dtype=np.float32)
    with standard_polyblep():
        _waves_match_jax(got, fr, shapes)


def _waves_match_jax(got, fr, shapes):
    for v in range(3):
        jph, pph, f = jnp.asarray(got[v].numpy()), got[v], torch.tensor(fr[v])
        pairs = [(josc.sine(jph), posc.sine(pph)),
                 (josc.triangle(jph), posc.triangle(pph)),
                 (josc.saw(jph, jnp.asarray(fr[v]), SR), posc.saw(pph, f, SR)),
                 (josc.square(jph, jnp.asarray(fr[v]), SR),
                  posc.square(pph, f, SR)),
                 (josc.morph_osc(jph, 2.5, jnp.asarray(fr[v]), SR),
                  posc.morph_osc(pph, 2.5, f, SR)),
                 (josc.morph_osc(jph, jnp.asarray(shapes), jnp.asarray(fr[v]),
                                 SR),
                  posc.morph_osc(pph, torch.tensor(shapes), f, SR))]
        for want, have in pairs:
            np.testing.assert_allclose(have.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-6)


def test_polyblep_is_the_standard_residual():
    """The residual at phases around a wrap is the two-sample polyBLEP's
    (-(1 - t/dt)^2 after the wrap, (1 + (t - 1)/dt)^2 before it, 0
    elsewhere), evaluated in float64; so a saw at 1000 Hz stays within
    [-1, 1] and splits its drop of 2 at a wrap into two steps of about
    1."""
    dt = np.float32(0.05)
    t = np.float32(np.concatenate([np.linspace(0.0, 0.049, 50),
                                   np.linspace(0.1, 0.9, 9),
                                   np.linspace(0.951, 0.999, 49)]))
    t64, dt64 = t.astype(np.float64), np.float64(dt)
    want = np.where(t64 < dt64, -(1.0 - t64 / dt64) ** 2,
                    np.where(t64 > 1.0 - dt64, (1.0 + (t64 - 1.0) / dt64) ** 2,
                             0.0))
    got = posc._polyblep(torch.tensor(t), torch.tensor(dt)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    freq = torch.full((4800,), 1000.0)
    ph, _ = posc.phase_accumulate(torch.tensor(0.0), freq, SR)
    saw = posc.saw(ph, freq, SR).numpy()
    assert np.abs(saw).max() <= 1.0
    assert np.abs(np.diff(saw)).max() <= 1.0 + 2 * 2 * 1000.0 / SR


# ---------------------------------------------------------------------------
# 2. synth sources: a bank of three on one SynthDef, organ, sub3
# ---------------------------------------------------------------------------

def _sources(pkg):
    """dx7 x3 (one bank in both packages), an organ and a sub3 (detune 0)
    source in a sub-mixer, at dyadic frequencies; sub3's cutoff and shape
    are set at runtime."""
    main = pkg.Mixer("main")
    dx7 = pkg.synths.dx7()
    for k, (freq, dur) in enumerate(((375.0, 5000), (750.0, 3000),
                                     (1125.0, None))):
        main.add_source(pkg.SynthSource(dx7, pkg.SynthPlaybackOptions(
            frequency=freq, start_time=k * 700, duration=dur, volume=0.5,
            velocity=0.6 + 0.2 * k, fade_in_secs=0.002), name=f"dx{k}"))
    sub = main.add_mixer(pkg.Mixer("sub"))
    sub.add_source(pkg.SynthSource(pkg.synths.organ(), pkg.SynthPlaybackOptions(
        frequency=375.0, duration=6000, panning=-0.4), name="organ"))
    sub.add_source(pkg.SynthSource(pkg.synths.sub3(detune_cents=0.0),
                                   pkg.SynthPlaybackOptions(
        frequency=750.0, start_time=300, panning=0.5), name="sub3"))
    return main


def _schedule_sources(prog):
    prog.set_parameter("main/sub/sub3", "CUTF", 900.0, at_frame=BLOCK + 100)
    prog.set_parameter("main/sub/sub3", "SHAP", 0.0, at_frame=2 * BLOCK)
    prog.stop_source("main/dx2", at_frame=2 * BLOCK + 500)


@pytest.fixture(scope="module")
def jax_sources():
    with standard_polyblep():
        prog = _program(JAX, _sources(JAX), SR, BLOCK)
        _schedule_sources(prog)
        assert len(prog.gen_batches) == 1  # the dx7 bank
        return prog, _render(JAX, prog, 3 * BLOCK)


def test_synth_sources_match_jax(jax_sources):
    jprog, want = jax_sources
    prog = _program(PORT, _sources(PORT), SR, BLOCK)
    _schedule_sources(prog)
    assert sorted(len(p.paths) for p in prog.pools) == [1, 1, 3]
    _close(_render(PORT, prog, 3 * BLOCK), want, BLOCK)
    assert (prog.natural_duration_frames() is None
            and jprog.natural_duration_frames() is None)


def test_bank_equals_unbatched():
    """Three sources on one SynthDef render as one bank exactly as apart."""
    progs = [pt.RenderProgram(_sources(pt), pt.EngineConfig(
        block_frames=BLOCK, batch_sources=batch, device="cpu"))
        for batch in (True, False)]
    got, want = (p.render(2 * BLOCK) for p in progs)
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# 3. synth generators
# ---------------------------------------------------------------------------

def _generators(pkg):
    """At GEN_SR: sub3 (detune 0) over notes 45/57/69/81 with a steal-free
    4-voice schedule; an organ of one voice that glides 45 -> 57 when its
    voice is retriggered; a dx7 whose note speed is set, then glided."""
    main = pkg.Mixer("main")
    opts = pkg.GeneratorPlaybackOptions
    g1 = pkg.SynthGenerator(pkg.synths.sub3(detune_cents=0.0), opts(voices=4),
                            release_secs=0.05, name="sub3")
    for k, note in enumerate((45, 57, 69, 81)):
        nid = g1.note_on(note, 0.5 + 0.1 * k, -0.3 + 0.2 * k, time=k * 480)
        g1.note_off(nid, time=k * 480 + 2500)
    g2 = pkg.SynthGenerator(pkg.synths.organ(), opts(voices=1, volume=0.7),
                            release_secs=0.02, glide_secs=0.01, name="organ")
    # the second note takes the voice the first one freed (a steal raises
    # in the JAX package: its generator lacks the allocator's ``envelope``)
    g2.note_off(g2.note_on(45, 0.8, time=100), time=900)
    nid = g2.note_on(57, 0.8, time=GEN_BLOCK + 300)
    g2.note_off(nid, time=2 * GEN_BLOCK + 900)
    g3 = pkg.SynthGenerator(pkg.synths.dx7(), opts(voices=2), release_secs=0.1,
                            name="dx7")
    nid = g3.note_on(45, 0.9, 0.2, time=50)
    g3.set_note_speed(nid, 2.0 ** (-3 / 12) * 1.25, time=1500)
    g3.set_note_speed(nid, 0.6, glide=24.0, time=GEN_BLOCK + 700)
    g3.set_note_volume(nid, 0.5, time=2 * GEN_BLOCK + 100)
    g3.note_off(nid, time=2 * GEN_BLOCK + 1500)
    for g in (g1, g2, g3):
        main.add_source(g)
    return main


@pytest.fixture(scope="module")
def jax_generators():
    with standard_polyblep():
        prog = _program(JAX, _generators(JAX), GEN_SR, GEN_BLOCK)
        want = _render(JAX, prog, 3 * GEN_BLOCK)
        state1, _ = prog.step_packed(prog.init_state(),
                                     prog.packed_block_inputs(0))
    return prog, want, jax.device_get(state1)


def test_synth_generators_match_jax(jax_generators):
    jprog, want, _ = jax_generators
    prog = _program(PORT, _generators(PORT), GEN_SR, GEN_BLOCK)
    assert [len(p.paths) for p in prog.pools] == [1, 1, 1]
    _close(_render(PORT, prog, 3 * GEN_BLOCK), want, GEN_BLOCK)
    assert prog.natural_duration_frames() == jprog.natural_duration_frames()


def test_state_carried_from_jax(jax_generators):
    """The JAX state after block 0, carried over, renders blocks 1-2."""
    _, want, state1 = jax_generators
    prog = _program(PORT, _generators(PORT), GEN_SR, GEN_BLOCK)
    state = state_from_jax(state1, prog)
    assert state["pools"][0]["synth"]["svf"].ic1.abs().sum() > 0
    out = []
    for b in (1, 2):
        state, y = prog.step(state, prog.block_inputs(b))
        out.append(y.numpy())
    _close(np.concatenate(out, axis=1), want[:, GEN_BLOCK:], GEN_BLOCK)


def test_freq_mult_is_one_without_automation():
    """Every MIDI note's lowered speed over its divisor is exactly 1, so an
    unautomated voice plays its note's frequency."""
    notes = torch.arange(128, dtype=torch.float32)
    spd = torch.tensor(np.float32([2.0 ** ((k - 60) / 12.0)
                                   for k in range(128)]))
    assert torch.equal(spd / note_speed(notes), torch.ones(128))


# ---------------------------------------------------------------------------
# 4. user parameters and modulation (tests/test_modulation_config.py's
#    brightness synth, written once in jnp and once in torch)
# ---------------------------------------------------------------------------

def _brightness(pkg):
    """A tone whose amplitude is the CUTF user parameter plus its
    modulation."""
    cutf = pkg.FloatParameter("CUTF", "Brightness", 0.0, 1.0, 0.25,
                              smoothing=None)
    if pkg is JAX:
        def init(ctx):
            return {}

        def render(state, sctx):
            level = sctx.params["CUTF"] + sctx.mods.get(
                "CUTF", jnp.zeros(sctx.block_frames))
            t = sctx.age.astype(jnp.float32) / sctx.sample_rate
            tone = jnp.sin(2.0 * jnp.pi * sctx.freq * t)
            return state, tone * level * sctx.gate
    else:
        def init(ctx, batch):
            return {}

        def render(state, sctx):
            level = sctx.params["CUTF"] + sctx.mods.get("CUTF", 0.0)
            t = sctx.age.to(torch.float32) * recip32(sctx.sample_rate)
            tone = torch.sin(2.0 * np.pi * sctx.freq * t)
            return state, tone * level * sctx.gate
    return pkg.SynthDef(init=init, render=render, channels=1, params=(cutf,))


def _modulated(pkg):
    main = pkg.Mixer("main")
    cfg = pkg.ModulationConfig(
        sources=(pkg.EnvelopeSource("ENV1", attack=0.02, sustain=1.0,
                                    release=0.1),),
        targets=("CUTF",))
    g = pkg.SynthGenerator(_brightness(pkg), pkg.GeneratorPlaybackOptions(
        voices=2), release_secs=0.01, name="bright").with_modulation(cfg)
    g.set_modulation("ENV1", "CUTF", 0.75, bipolar=False)
    g.note_on(45, 1.0, time=0)
    g.note_on(57, 0.7, time=900)
    main.add_source(g)
    return main


def test_modulated_user_parameter_matches_jax():
    """The envelope routed to CUTF, and CUTF set at runtime."""
    outs = []
    for pkg in (JAX, PORT):
        prog = _program(pkg, _modulated(pkg), GEN_SR, GEN_BLOCK)
        prog.set_parameter("main/bright", "CUTF", 0.1, at_frame=GEN_BLOCK + 64)
        outs.append(_render(pkg, prog, 2 * GEN_BLOCK))
    want, got = outs
    _close(got, want, GEN_BLOCK)
    early = np.abs(got[0, 100:400]).max()
    late = np.abs(got[0, 1500:2000]).max()
    assert early < 0.7 < late


def _modulated_sub3(pkg):
    """sub3 (detune 0) at GEN_SR with an envelope on its shape and the
    velocity on its cutoff, each of 6 voices starting at most one note per
    block over 3 blocks and no voice stolen; one note's volume and pan
    automated, and the cutoff set at runtime."""
    main = pkg.Mixer("main")
    g = pkg.SynthGenerator(pkg.synths.sub3(detune_cents=0.0),
                           pkg.GeneratorPlaybackOptions(voices=6),
                           release_secs=0.02, name="sub3")
    g.with_modulation(pkg.ModulationConfig(
        sources=(pkg.EnvelopeSource("ENV2", attack=0.005, decay=0.02,
                                    sustain=0.2, release=0.01),
                 pkg.VelocitySource()),
        targets=("CUTF", "SHAP")))
    g.set_modulation("VELM", "CUTF", 0.4, bipolar=False)
    g.set_modulation("ENV2", "SHAP", 0.5, bipolar=False)
    for k, note in enumerate((45, 57, 69, 81)):
        nid = g.note_on(note, 0.5 + 0.1 * k, -0.3 + 0.2 * k, time=k * 300)
        g.note_off(nid, time=k * 300 + 1500)
    nid = g.note_on(57, 0.9, time=GEN_BLOCK + 200)
    g.set_note_volume(nid, 0.4, time=GEN_BLOCK + 900)
    g.set_note_panning(nid, 0.6, time=2 * GEN_BLOCK + 100)
    g.note_off(nid, time=2 * GEN_BLOCK + 1200)
    g.note_off(g.note_on(69, 0.7, time=2 * GEN_BLOCK + 400),
               time=2 * GEN_BLOCK + 1000)
    main.add_source(g)
    return main


def test_modulated_sub3_with_one_start_per_voice_matches_jax():
    """Where no voice starts more than one note in a block the port's
    trigger slots render as the JAX package's one trigger per voice:
    sub3 with its modulation matrix, per-note automation and the cutoff
    set at runtime (the generators above add glides and note speeds)."""
    outs = []
    with standard_polyblep():
        for pkg in (JAX, PORT):
            prog = _program(pkg, _modulated_sub3(pkg), GEN_SR, GEN_BLOCK)
            prog.set_parameter("main/sub3", "CUTF", 900.0,
                               at_frame=GEN_BLOCK + 64)
            outs.append(_render(pkg, prog, 3 * GEN_BLOCK))
    want, got = outs
    _close(got, want, GEN_BLOCK)


def test_modulation_targets_must_be_user_parameters():
    g = pt.SynthGenerator(pt.synths.dx7())
    with pytest.raises(ValueError, match="not user parameters"):
        g.with_modulation(pt.ModulationConfig(
            sources=(pt.EnvelopeSource("ENV1"),), targets=("CUTF",)))
    with pytest.raises(ValueError, match="with_modulation"):
        g.set_modulation("ENV1", "CUTF", 0.5)


# ---------------------------------------------------------------------------
# 5. the Player
# ---------------------------------------------------------------------------

def test_player_plays_synths():
    """``play_generator`` of a synth generator and ``play_synth`` return the
    port's handles, and the Player's blocks equal the same graph's render
    (the Player's master gain is 1); a finished synth source retires."""
    player = Player(NullOutput(SR, 2), PlayerConfig(
        block_frames=BLOCK, retire_after_dead_sources=1), device="cpu")
    gen = pt.SynthGenerator(pt.synths.sub3(), pt.GeneratorPlaybackOptions(
        voices=4), release_secs=0.05)
    for k, note in enumerate((48, 55, 60)):
        gen.note_on(note, 0.7, time=k * 300)
    gh = player.play_generator(gen)
    sh = player.play_synth(pt.synths.dx7(), pt.SynthPlaybackOptions(
        frequency=375.0, duration=3000, fade_out_secs=0.01), context="tone")
    assert isinstance(gh, GeneratorPlaybackHandle)
    assert isinstance(sh, PlaybackHandle)
    prog = pt.RenderProgram(player.main_mixer, pt.EngineConfig(
        block_frames=BLOCK, device="cpu"))
    got = np.concatenate([player.render_block() for _ in range(2)], axis=1)
    want = prog.render(2 * BLOCK)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert not sh.is_playing() and player._is_playing(gen)
    assert player.main_mixer.find_parent_of(sh._node) is None  # retired


def test_synth_player_graph():
    """synth64.synth_player builds the synth_64v graph live: the generator,
    a bank of 16 sources in one LeafBatch, the filter and the pan."""
    player = pt.synth64.synth_player(block_frames=1024, device="cpu")
    audio = player.render_block()
    prog = player._program
    assert sorted(len(p.paths) for p in prog.pools) == [1, 16]
    assert np.isfinite(audio).all() and np.abs(audio).max() > 0.1
