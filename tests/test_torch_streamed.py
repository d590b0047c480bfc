"""Streamed file playback (phonic_tpu_torch/sources/streamed.py) against the
JAX package on the CPU.

Files are written to ``tmp_path``: a 48 kHz stereo one (a rate ratio of 1,
so with speeds 1, 1.5 and 0.75 every read position is exact in both
packages) and a 44.1 kHz one played at constant speed.  The port's host
sums the device's float32 steps where the JAX package integrates in
float64 (a drift of ~1e-8 frames per frame at 44.1 kHz, -100 dB and below
over these renders).  Held to -90 dB of each block's peak:

* sources from a path and from an ``AudioFileBuffer``; speed events, a
  loop range with repeats, runtime loop-range and repeat messages, a seek
  and a stop; three sources batched in one bank, equal to the three
  apart; the host windows themselves, block by block;
* the speed-cap error (the JAX package clamps the speed silently);
* ``Player.play_file(stream=True)`` equals the same graph's render.
"""

import numpy as np
import pytest

import phonic_tpu as jp
import phonic_tpu_torch as pt
from phonic_tpu.sources.streamed import StreamedFileSource as JStreamed
from phonic_tpu_torch.errors import ParameterError
from phonic_tpu_torch.io import wav as pwav
from phonic_tpu_torch.outputs.null import NullOutput
from phonic_tpu_torch.player import PlaybackHandle, Player, PlayerConfig
from phonic_tpu_torch.sources.streamed import StreamedFileSource

SR = 48000
BLOCK = 4096
BLOCKS = 3
DB90 = 10.0 ** (-90.0 / 20.0)


def _write(path, sr, frames, freqs):
    t = np.arange(frames) / sr
    x = np.stack([0.4 * np.sin(2 * np.pi * f * t) * np.exp(-t)
                  for f in freqs]).astype(np.float32)
    pwav.write_wav(path, x, sr, bits=32, float_format=True)
    return str(path)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("streamed")
    return (_write(d / "a48.wav", SR, 20000, (220.0, 330.0)),
            _write(d / "b48.wav", SR, 9000, (150.0, 275.0)),
            _write(d / "c44.wav", 44100, 15000, (180.0, 240.0)))


def _graph(pkg, files):
    """Four streamed sources: at 48 kHz, one bank of three (a looped one
    with repeats and speed changes, one from a preloaded buffer with a seek
    and a stop, a late start), and a 44.1 kHz one with a runtime loop range
    and repeat count."""
    a48, b48, c44 = files
    S = JStreamed if pkg is jp else StreamedFileSource
    opts = pkg.FilePlaybackOptions
    main = pkg.Mixer("main")
    main.add_source(S(a48, opts(volume=0.7, repeat=2, loop_range=(1000, 9000),
                                panning=-0.3), name="looped"))
    buf = S(pkg.AudioFileBuffer.from_file(b48), opts(volume=0.6, panning=0.4),
            name="buffer")
    buf.seek(5000, 3000.0)
    main.add_source(buf)
    main.add_source(S(b48, opts(volume=0.5, start_time=700), name="late"))
    c = S(c44, opts(volume=0.5), name="c44")
    c.set_loop_range((2000, 7000), time=2 * BLOCK + 100)
    c.set_repeat(1, time=2 * BLOCK + 200)
    main.add_source(c)
    return main


def _schedule(prog):
    prog.set_parameter("main/looped", "SPED", 1.5, at_frame=3000)
    prog.set_parameter("main/looped", "SPED", 0.75, at_frame=BLOCK + 2500)
    prog.set_parameter("main/late", "VOLU", 0.25, at_frame=BLOCK + 10)
    prog.stop_source("main/buffer", at_frame=2 * BLOCK + 1000)


def _port_program(files, **config):
    prog = pt.RenderProgram(_graph(pt, files), pt.EngineConfig(
        block_frames=BLOCK, device="cpu", **config))
    _schedule(prog)
    return prog


def _close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    for b in range(BLOCKS):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        peak = np.abs(want[:, sl]).max()
        assert peak > 0.05
        err = np.abs(got[:, sl] - want[:, sl]).max()
        assert err <= DB90 * peak, f"block {b}: {20 * np.log10(err / peak):.1f} dB"


def test_streamed_matches_jax(files):
    jprog = jp.RenderProgram(_graph(jp, files), jp.EngineConfig(
        block_frames=BLOCK))
    _schedule(jprog)
    want = jprog.render(BLOCKS * BLOCK, mode="loop")
    prog = _port_program(files)
    # the three 48 kHz sources share a bank (one window shape and cap)
    assert sorted(len(p.paths) for p in prog.pools) == [1, 3]
    _close(prog.render(BLOCKS * BLOCK), want)
    assert prog.natural_duration_frames() == jprog.natural_duration_frames()


def test_bank_equals_unbatched(files):
    got, want = (_port_program(files, batch_sources=b).render(BLOCKS * BLOCK)
                 for b in (True, False))
    assert np.abs(want).max() > 0.1
    np.testing.assert_array_equal(got, want)


def test_window_lowering_matches_jax(files):
    """The host timeline's windows, block by block: the same frames, live
    masks and fractions (the 48 kHz source, whose steps are exact)."""
    jsrc = JStreamed(files[0], jp.FilePlaybackOptions(
        repeat=2, loop_range=(1000, 9000)))
    psrc = StreamedFileSource(files[0], pt.FilePlaybackOptions(
        repeat=2, loop_range=(1000, 9000)))
    for src, pkg in ((jsrc, jp), (psrc, pt)):
        main = pkg.Mixer("main")
        main.add_source(src)
        src.seek(9000, 500.0)
        src.handle_message(("set_repeat", 0), time=3 * BLOCK)
        cfg = (jp.EngineConfig(block_frames=BLOCK) if pkg is jp else
               pt.EngineConfig(block_frames=BLOCK, device="cpu"))
        pkg.RenderProgram(main, cfg)
    for b in range(6):
        want = jsrc.lower_block_inputs(b * BLOCK, BLOCK)
        got = psrc.lower_block_inputs(b * BLOCK, BLOCK)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)


def test_speed_above_cap_raises(files):
    prog = _port_program(files)
    prog.set_parameter("main/looped", "SPED", 3.5, at_frame=BLOCK)
    with pytest.raises(ParameterError, match="speed_cap"):
        prog.render(BLOCKS * BLOCK)


def test_player_plays_streamed(files):
    """``play_file(stream=True)`` returns the port's handle, echoes its
    context, and renders as the same graph does."""
    player = Player(NullOutput(SR, 2), PlayerConfig(block_frames=BLOCK),
                    device="cpu")
    events = []
    player.status_handler = events.append
    handle = player.play_file(files[0], pt.FilePlaybackOptions(volume=0.8),
                              stream=True, context="stream")
    assert isinstance(handle, PlaybackHandle)
    assert isinstance(handle._node, StreamedFileSource)
    prog = pt.RenderProgram(player.main_mixer, pt.EngineConfig(
        block_frames=BLOCK, device="cpu"))
    got = np.concatenate([player.render_block() for _ in range(2)], axis=1)
    want = prog.render(2 * BLOCK)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert events and events[0].context == "stream"
