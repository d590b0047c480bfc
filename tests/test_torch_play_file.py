"""The play_file slice of the port against the JAX package, on the CPU.

* ``sinc_table`` equals the JAX package's bit for bit; ``sinc_read``
  agrees to 1e-6, with positions inside and outside the buffer.
* File sources at ``resampling_quality="high"`` (speeds 0.75 and 1.5, at
  the engine rate and from a 44.1 kHz buffer, a bank of two, a speed glide
  above the initial speed) render as the JAX package's do, to -90 dB of
  peak, over three 4096-frame blocks.
* BASELINE config 1 (bench.py ``config_play_file``) through
  ``play_file_program`` at 8192-frame blocks matches to -90 dB.
* ``natural_duration_frames`` equals the JAX package's to the frame on the
  headline and mastering graphs built with ``repeat=0``, bench.py's sampler
  graph, and with a scheduled stop or kill; it is None on an endless graph,
  where ``render()`` raises as the JAX package's does.  ``render()`` renders
  that many frames.
* ``set_parameter_normalized``, ``set_parameter_glide`` and
  ``remove_pending_events`` (one node; the whole graph with a pending stop)
  render as the JAX package's do; the reverb's ``"reset"`` message too.
* ``state_from_jax`` carries a sinc bank's position over; ``render_file``
  writes what ``render()`` returns.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
import phonic_tpu as jp
import phonic_tpu_torch as pt
from phonic_tpu.effects.eq5 import Eq5Effect as JEq5
from phonic_tpu.effects.gain import GainEffect as JGain
from phonic_tpu.effects.reverb import ReverbEffect as JReverb
from phonic_tpu.ops import resample as jresample
from phonic_tpu_torch.convert import state_from_jax
from phonic_tpu_torch.effects.chorus import ChorusEffect
from phonic_tpu_torch.effects.eq5 import Eq5Effect
from phonic_tpu_torch.effects.gain import GainEffect
from phonic_tpu_torch.effects.reverb import ReverbEffect
from phonic_tpu_torch.io import wav as pwav
from phonic_tpu_torch.ops import resample as presample
from phonic_tpu_torch.play_file import file_program, play_file_program
from test_torch_mastering import _jax_mastering_chain
from test_torch_slice import _jax_mixer_graph

SR = 48000
BLOCK = 4096
DB90 = 10.0 ** (-90.0 / 20.0)

JAX_EFFECTS = {Eq5Effect: JEq5, GainEffect: JGain, ReverbEffect: JReverb}


def _close(got, want, min_peak=0.05):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    peak = np.abs(want).max()
    assert peak > min_peak
    err = np.abs(got - want).max()
    assert err <= DB90 * peak, (err, peak)


def _buffer(pkg, frames, sr=SR, ch=1, seed=0, band=(150.0, 3000.0)):
    """A few partials in ``band`` (Hz) with raised-cosine ends, so a read
    across the buffer's edges or its loop wrap meets no step."""
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / sr
    f = rng.uniform(*band, (ch, 4, 1))
    x = 0.2 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6, (ch, 4, 1))).sum(1)
    edge = 0.5 - 0.5 * np.cos(np.pi * np.arange(256) / 256)
    x[:, :256] *= edge
    x[:, -256:] *= edge[::-1]
    return pkg.AudioFileBuffer.from_array(x.astype(np.float32), sr)


def _programs(graph_of, block=BLOCK):
    """The same graph as a JAX program and a CPU port program."""
    jprog = jp.RenderProgram(graph_of(jp), jp.EngineConfig(
        sample_rate=SR, block_frames=block))
    prog = pt.RenderProgram(graph_of(pt), pt.EngineConfig(
        sample_rate=SR, block_frames=block, device="cpu"))
    return jprog, prog


# ---------------------------------------------------------------------------
# the sinc read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cutoff", [1.0, 44100 / 48000 / 1.5, 0.5])
def test_sinc_table_matches_jax(cutoff):
    got = presample.sinc_table(cutoff=cutoff)
    want = np.asarray(jresample.sinc_table(cutoff=cutoff))
    assert got.dtype == np.float32 and got.shape == (513, 32)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 2])
def test_sinc_read_matches_jax(channels):
    """Random positions, a fifth of them outside [0, frames) or within a
    half window of its edges, where taps read the fill value; lanes of a
    bank [S, C, F] against the JAX read per lane, to 1e-6."""
    rng = np.random.default_rng(channels)
    frames, n = 3000, 4096
    buf = rng.uniform(-0.5, 0.5, (2, channels, frames)).astype(np.float32)
    pos = rng.uniform(0, frames, (2, n)).astype(np.float32)
    pos[:, ::5] = rng.uniform(-40, frames + 40, (2, n // 5 + 1)).astype(np.float32)
    pos[:, 1::97] = np.round(pos[:, 1::97])  # whole positions
    table = presample.sinc_table(cutoff=0.8)
    got = presample.sinc_read(torch.as_tensor(buf), torch.as_tensor(pos),
                              torch.tensor(table), fill=0.1).numpy()
    jtable = jresample.sinc_table(cutoff=0.8)
    for lane in range(2):
        want = np.asarray(jresample.sinc_read(
            jnp.asarray(buf[lane]), jnp.asarray(pos[lane]), jtable, fill=0.1))
        assert got[lane].shape == want.shape == (channels, n)
        assert np.abs(got[lane] - want).max() <= 1e-6


# Under a glide the read positions come from float32 cumulative sums of
# the steps, which the two packages associate differently (the JAX sum lands
# ~1.7e-4 frames from the float64 sum over a 4096-frame block, the port's
# ~3e-5); the renders then differ by that times the signal's slope, so the
# glide reads partials under 600 Hz (~-97 dB; -85 dB with partials up to
# 3 kHz, at either quality).
SINC_CASES = {
    # name: [(speed, buffer rate, channels)] per source, glide (to, at, rate)
    "slow48": ([(0.75, SR, 1)], None),
    "fast48": ([(1.5, SR, 1)], None),
    "slow44": ([(0.75, 44100, 2)], None),
    "fast44": ([(1.5, 44100, 2)], None),
    "bank44": ([(1.5, 44100, 1), (0.75, 44100, 1)], None),
    "glide44": ([(1.0, 44100, 1)], (1.6, 1000, 48.0)),
}


def _sinc_graph(name):
    specs, glide = SINC_CASES[name]
    band = (100.0, 600.0) if glide else (150.0, 3000.0)

    def graph(pkg):
        main = pkg.Mixer("main")
        for i, (speed, sr, ch) in enumerate(specs):
            main.add_source(pkg.FileSource(
                _buffer(pkg, 7000, sr, ch, seed=i, band=band),
                pkg.FilePlaybackOptions(speed=speed, repeat=None, panning=0.3,
                                        resampling_quality="high"),
                name=f"s{i}"))
        return main
    return graph


@pytest.mark.parametrize("name", sorted(SINC_CASES))
def test_sinc_render_matches_jax(name):
    jprog, prog = _programs(_sinc_graph(name))
    glide = SINC_CASES[name][1]
    if glide is not None:
        for p in (jprog, prog):
            p.set_parameter_glide("main/s0", "SPED", glide[0], glide[2],
                                  at_frame=glide[1])
        # the glide above the initial speed lifts the step bound with it,
        # so the clamp in FileBatch.lane_pos never binds
        assert prog.file_batches[0].sources[0].speed_bucket(SR) == 1
    assert len(prog.file_batches) == 1 and prog.file_batches[0].sinc is not None
    want = jprog.render(3 * BLOCK, mode="loop")
    got = prog.render(3 * BLOCK)
    for b in range(3):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        _close(got[:, sl], want[:, sl])


def test_play_file_config_matches_jax():
    """bench.py's config 1 (endless tone at speed 1.09, Hermite read) at
    8192-frame blocks, three blocks."""
    block = 8192
    jprog = jp.RenderProgram(bench.config_play_file().root, jp.EngineConfig(
        sample_rate=SR, block_frames=block))
    want = jprog.render(3 * block, mode="loop")
    prog = play_file_program(block_frames=block, device="cpu")
    assert len(prog.file_batches) == 1 and prog.file_batches[0].sinc is None
    got = prog.render(3 * block)
    for b in range(3):
        sl = slice(b * block, (b + 1) * block)
        _close(got[:, sl], want[:, sl])


# ---------------------------------------------------------------------------
# natural length
# ---------------------------------------------------------------------------

def _finite(main):
    """Every file source of the graph plays once (repeat=0)."""
    for s in main.sources:
        s.options = dataclasses.replace(s.options, repeat=0)
    for c in main.children:
        _finite(c)
    return main


def _config1(pkg):
    main = pkg.Mixer("main")
    main.add_source(pkg.FileSource(pkg.AudioFileBuffer.from_array(
        bench._tone().data[:, :-1], SR), pkg.FilePlaybackOptions(
            volume=0.8, panning=0.2, speed=1.09, repeat=None), name="file"))
    return main


NATURAL = {
    "headline": (lambda: _finite(pt.headline.mixer_graph()),
                 lambda: _finite(_jax_mixer_graph()), None),
    "mastering": (lambda: _finite(pt.mastering_chain()),
                  lambda: _finite(_jax_mastering_chain()), None),
    "sampler": (pt.sampler_graph, lambda: bench.config_sampler_64().root, None),
    "stopped": (lambda: _config1(pt), lambda: _config1(jp), False),
    "killed": (lambda: _config1(pt), lambda: _config1(jp), True),
}


@pytest.mark.parametrize("name", sorted(NATURAL))
def test_natural_duration_matches_jax(name):
    port_graph, jax_graph, kill = NATURAL[name]
    prog = pt.RenderProgram(port_graph(), pt.EngineConfig(
        sample_rate=SR, block_frames=BLOCK, device="cpu"))
    jprog = jp.RenderProgram(jax_graph(), jp.EngineConfig(
        sample_rate=SR, block_frames=BLOCK))
    if kill is not None:
        for p in (prog, jprog):
            p.stop_source("main/file", at_frame=30000, kill=kill)
    got = prog.natural_duration_frames()
    assert got == jprog.natural_duration_frames()
    if kill is not None:
        assert got == (30000 if kill else 30000 + int(0.05 * SR) + 1)


def test_endless_graph_has_no_natural_length():
    prog = play_file_program(block_frames=BLOCK, device="cpu")
    jprog = jp.RenderProgram(_config1(jp), jp.EngineConfig(block_frames=BLOCK))
    assert prog.natural_duration_frames() is None
    assert jprog.natural_duration_frames() is None
    with pytest.raises(ValueError, match="endless") as want:
        jprog.render()
    with pytest.raises(ValueError, match="endless") as got:
        prog.render()
    assert str(got.value) == str(want.value)


def test_render_without_length_renders_natural_length():
    """One 44.1 kHz file played once at speed 1.3 through EQ5 (a 0.2 s
    tail) and a gain stage: ceil(9000 / (0.91875 * 1.3)) + 9600 frames."""
    def graph(pkg):
        main = pkg.Mixer("main")
        main.add_source(pkg.FileSource(_buffer(pkg, 9000, 44100), pkg.FilePlaybackOptions(
            speed=1.3, repeat=0), name="file"))
        eq, gain = Eq5Effect, GainEffect
        if pkg is jp:
            eq, gain = JAX_EFFECTS[eq], JAX_EFFECTS[gain]
        main.add_effect(eq(gains=[3.0, -2.0, 0.0, 1.0, -4.0], name="eq"))
        main.add_effect(gain(gain=0.7, name="gain"))
        return main

    jprog, prog = _programs(graph)
    n = prog.natural_duration_frames()
    assert n == jprog.natural_duration_frames() == 7536 + SR // 5
    got = prog.render()
    assert got.shape == (2, n) and np.isfinite(got).all()
    assert np.abs(got[:, 7536:]).max() > 1e-6  # the EQ's ring-out


# ---------------------------------------------------------------------------
# the control surface
# ---------------------------------------------------------------------------

def _control_graph(pkg):
    """Two sources and a gain stage; partials under 600 Hz, as the sinc
    glide's, because one case glides."""
    low = (100.0, 600.0)
    main = pkg.Mixer("main")
    main.add_source(pkg.FileSource(_buffer(pkg, 6000, band=low),
                                   pkg.FilePlaybackOptions(repeat=None), name="a"))
    main.add_source(pkg.FileSource(_buffer(pkg, 5000, 44100, seed=1, band=low),
                                   pkg.FilePlaybackOptions(speed=0.8, repeat=None),
                                   name="b"))
    gain = JAX_EFFECTS[GainEffect] if pkg is jp else GainEffect
    main.add_effect(gain(gain=0.9, name="gain"))
    return main


def _events(prog):
    prog.set_parameter("main/a", "VOLU", 0.2, at_frame=3000)
    prog.set_parameter("main/a", "VOLU", 0.9, at_frame=9000)
    prog.set_parameter("main/b", "VOLU", 0.3, at_frame=9000)
    prog.set_parameter("main/gain", "GAIN", 0.5, at_frame=10000)
    prog.stop_source("main/b", at_frame=8000)
    prog.stop_source("main/a", at_frame=11000, kill=True)


CONTROL = {
    "normalized": lambda p: (
        p.set_parameter_normalized("main/a", "VOLU", 0.35, at_frame=1500),
        p.set_parameter_normalized("main/gain", "GAIN", 0.6, at_frame=5000),
        p.set_parameter_normalized("main/b", "PANN", 0.1, at_frame=7000)),
    "glide": lambda p: (
        p.set_parameter_glide("main/a", "SPED", 1.6, 48.0, at_frame=1000),
        p.set_parameter_glide("main/b", "SPED", 0.5, 24.0,
                              at_frame=BLOCK + 512)),
    "remove_node": lambda p: (
        _events(p), p.remove_pending_events("main/a", after_frame=5000)),
    "remove_all": lambda p: (
        _events(p), p.remove_pending_events(after_frame=5000)),
}


@pytest.mark.parametrize("name", sorted(CONTROL))
def test_control_surface_matches_jax(name):
    jprog, prog = _programs(_control_graph)
    for p in (jprog, prog):
        CONTROL[name](p)
    for key, tl in prog.timelines.items():
        jtl = jprog.timelines[key]
        assert (tl.times, tl.values, tl.ramps) == (jtl.times, jtl.values,
                                                    jtl.ramps), key
    assert prog.stop_frames == jprog.stop_frames
    assert prog.kill_frames == jprog.kill_frames
    want = jprog.render(3 * BLOCK, mode="loop")
    got = prog.render(3 * BLOCK)
    for b in range(3):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        _close(got[:, sl], want[:, sl])


def _reverb_graph(pkg):
    main = pkg.Mixer("main")
    main.add_source(pkg.FileSource(_buffer(pkg, 6000), pkg.FilePlaybackOptions(
        repeat=None), name="a"))
    reverb = JAX_EFFECTS[ReverbEffect] if pkg is jp else ReverbEffect
    main.add_effect(reverb(room_size=0.6, wet=0.5, min_room_size=0.55,
                           name="reverb"))
    return main


def test_reverb_reset_message_matches_jax():
    """A "reset" sent through ``handle_message`` flushes the reverb at the
    block holding its time, in both packages; ("reset",) is the same
    message, and the render differs from one without it."""
    jprog, prog = _programs(_reverb_graph)
    for p in (jprog, prog):
        assert p.nodes["main/reverb"].handle_message("reset", time=BLOCK + 10) is None
    want = jprog.render(2 * BLOCK, mode="loop")
    got = prog.render(2 * BLOCK)
    for b in range(2):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        _close(got[:, sl], want[:, sl])
    tuple_form = pt.RenderProgram(_reverb_graph(pt), prog.config)
    tuple_form.nodes["main/reverb"].handle_message(("reset",), time=BLOCK)
    assert np.array_equal(tuple_form.render(2 * BLOCK), got)
    plain = pt.RenderProgram(_reverb_graph(pt), prog.config).render(2 * BLOCK)
    assert np.abs(plain[:, BLOCK:] - got[:, BLOCK:]).max() > 1e-3
    for node in (prog.nodes["main/reverb"], jprog.nodes["main/reverb"]):
        with pytest.raises(ValueError, match="unknown reverb message"):
            node.handle_message("flush")


def test_default_handle_message_ignores():
    """Every ported node takes messages; those without a route ignore
    them, as the JAX package's nodes do."""
    assert GainEffect().handle_message("anything", time=5) is None
    assert JGain().handle_message("anything", time=5) is None
    nodes = [Eq5Effect(), ChorusEffect(), ReverbEffect(), pt.GateEffect(),
             pt.CompressorEffect(), pt.DelayEffect(), pt.DistortionEffect(),
             pt.FileSource(_buffer(pt, 1000)), pt.Sampler(_buffer(pt, 1000))]
    assert all(callable(getattr(n, "handle_message", None)) for n in nodes)
    assert pt.FileSource(_buffer(pt, 1000)).handle_message("x") is None


# ---------------------------------------------------------------------------
# state carried over, files in and out
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["fast44", "bank44"])
def test_sinc_state_carried_from_jax(name):
    """One block in JAX, its state carried over with ``state_from_jax``,
    the next block in the port.  JAX's bank of two also carries its
    "sinc" table and "meta" arrays, which the port holds statically."""
    jprog, prog = _programs(_sinc_graph(name))
    want = jprog.render(2 * BLOCK, mode="loop")
    state1, _ = jprog.step_packed(jprog.init_state(),
                                  jprog.packed_block_inputs(0))
    state1 = jax.device_get(state1)
    if name == "bank44":
        assert {"sinc", "meta"} <= set(state1["file_batches"][0])
    state = state_from_jax(state1, prog)
    assert set(state["file_batches"][0]) == {"base", "frac", "frac_lo"}
    assert state["file_batches"][0]["base"].abs().sum() > 0
    _, y = prog.step(state, prog.block_inputs(1))
    _close(y.numpy(), want[:, BLOCK:])


def test_render_file_writes_the_render(tmp_path):
    """A 44.1 kHz stereo WAV rendered at high quality to its natural
    length, ceil(20000 / (44100 / 48000)) frames, read back exactly."""
    src, out = tmp_path / "in.wav", tmp_path / "out.wav"
    pwav.write_wav(src, _buffer(pt, 20000, 44100, ch=2).data[:, :-1], 44100)
    options = pt.FilePlaybackOptions(resampling_quality="high", volume=0.9)
    frames = pt.render_file(src, out, options, block_frames=8192, device="cpu")
    back, info = pwav.read_wav(out)
    prog = file_program(pt.AudioFileBuffer.from_file(src), options, 8192, "cpu")
    assert frames == prog.natural_duration_frames() == 21769
    assert info.sample_rate == SR and back.shape == (2, frames)
    assert np.array_equal(back, prog.render())


def test_sampler_from_file_matches_jax(tmp_path):
    path = tmp_path / "s.wav"
    pwav.write_wav(path, _buffer(pt, 3000, 44100).data[:, :-1], 44100)
    got = pt.Sampler.from_file(path, name="s").buffer
    want = jp.Sampler.from_file(path, name="s").buffer
    assert np.array_equal(got.data, want.data)
    assert got.sample_rate == want.sample_rate == 44100
