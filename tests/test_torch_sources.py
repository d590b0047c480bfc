"""File-source lane banks (phonic_tpu_torch/graph/batching.py) against the
JAX package, over the options the headline graph does not use: forward and
pingpong loops, repeats, fade-in, stop with fade-out, kill, seek, a speed
change, stereo buffers at another sample rate, and a source in a group of
one.  Both packages render the same graph of sources only (no effects) over
four 2048-frame blocks; the port must match to -90 dB of peak.
"""

import numpy as np
import pytest

import phonic_tpu as jp
import phonic_tpu_torch as pt

BLOCK = 2048
DB90 = 10.0 ** (-90.0 / 20.0)


def _graph(pkg):
    """Four batched groups of two plus one lone source; ``pkg`` is either
    package's top-level module (same API)."""
    rng = np.random.default_rng(3)

    def buf(frames, ch=1, sr=48000, loop=None, mode="forward"):
        t = np.arange(frames) / sr
        f = rng.uniform(100, 900, (ch, 1))
        x = (0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32)
        return pkg.AudioFileBuffer.from_array(x, sr, loop_range=loop,
                                              loop_mode=mode)

    opts = pkg.FilePlaybackOptions
    main = pkg.Mixer("main")
    specs = {
        "loop": lambda: (buf(3000, loop=(500, 2200)), opts(repeat=None, speed=1.7)),
        "ping": lambda: (buf(2500, loop=(300, 1400), mode="pingpong"),
                         opts(repeat=2, speed=1.3)),
        "fadein": lambda: (buf(2800), opts(repeat=1, fade_in_secs=0.01,
                                           start_time=700, speed=0.8)),
        "stereo": lambda: (buf(4000, ch=2, sr=44100), opts(repeat=None,
                                                          panning=0.4)),
    }
    for kind, make in specs.items():
        for i in range(2):
            b, o = make()
            main.add_source(pkg.FileSource(b, o, name=f"{kind}{i}"))
    lone, o = buf(5000, sr=32000), opts(repeat=0, speed=1.1)
    main.add_source(pkg.FileSource(lone, o, name="lone"))
    return main


def _schedule(prog):
    prog.stop_source("main/stereo0", at_frame=3000)
    prog.stop_source("main/loop1", at_frame=5000, kill=True)
    prog.set_parameter("main/ping1", "SPED", 0.6, at_frame=2500)
    prog.set_parameter("main/fadein0", "VOLU", 0.3, at_frame=4000)
    prog.nodes["main/stereo1"].seek(4096 + 10, 1234.5)


@pytest.fixture(scope="module")
def jax_audio():
    prog = jp.RenderProgram(_graph(jp), jp.EngineConfig(block_frames=BLOCK))
    _schedule(prog)
    return prog.render(4 * BLOCK)


@pytest.mark.parametrize("batch_sources", [True, False])
def test_sources_match_jax(jax_audio, batch_sources):
    prog = pt.RenderProgram(_graph(pt), pt.EngineConfig(
        block_frames=BLOCK, batch_sources=batch_sources, device="cpu"))
    assert len(prog.file_batches) == (5 if batch_sources else 9)
    _schedule(prog)
    got = prog.render(4 * BLOCK)
    peak = np.abs(jax_audio).max()
    assert peak > 0.1
    assert np.abs(got - jax_audio).max() <= DB90 * peak


def test_high_quality_resampling_is_not_ported_yet():
    with pytest.raises(NotImplementedError):
        pt.FilePlaybackOptions(resampling_quality="high").validate()
