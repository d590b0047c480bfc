"""The port's output devices (phonic_tpu_torch/outputs/rt.py, web.py and
base.default_output_device) on the CPU, mirroring tests/test_rt_output.py
and tests/test_web_output.py.

* The realtime bridge builds from phonic_tpu_torch/csrc/ringbuf.cpp into
  the package's ``_build/``; its sample-format conversion equals the JAX
  package's bit for bit (f32 / i32 / i16, clipping included).
* The ring paces the writer and counts frames; pause freezes the count; a
  named device that does not open falls back to the paced sink;
  ``open_with_config`` applies the config.
* ``default_output_device`` picks the realtime device when the bridge
  loads, else WAV (given a path), else null.
* The web device's stream header equals the JAX package's bytes, and a
  written block is served back.  Every socket read has a 5 s timeout.
"""

import struct
import threading
import time
import urllib.request

import numpy as np
import pytest

from phonic_tpu.outputs import rt as jrt
from phonic_tpu.outputs.web import _wav_stream_header as jax_header
from phonic_tpu_torch import default_output_device
from phonic_tpu_torch.outputs import NullOutput, WavOutput
from phonic_tpu_torch.outputs import base as pbase
from phonic_tpu_torch.outputs import rt
from phonic_tpu_torch.outputs.rt import (RtOutput, RtOutputConfig,
                                         convert_f32, rt_available)
from phonic_tpu_torch.outputs.web import WebOutput, _wav_stream_header

SR = 48000
TIMEOUT = 5


def test_bridge_builds_from_the_port():
    assert rt_available()
    path = rt._native_path()
    assert path.parent.parent.name == "_build"
    assert path.parent.parent.parent.name == "phonic_tpu_torch"
    assert path.name == "libphonic_rt.so"


@pytest.mark.parametrize("fmt", ["f32", "i32", "i16"])
def test_convert_f32_equals_jax(fmt):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.float32([0.0, 1.0, -1.0, 2.0, -2.0, 0.5, -0.25, 1.0 / 32767.0,
                    np.inf, -np.inf]),
        (3.0 * rng.standard_normal(4096)).astype(np.float32)])
    got, want = convert_f32(x, fmt), jrt.convert_f32(x, fmt)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_ring_paces_and_counts():
    out = RtOutput(SR, 2, buffer_secs=0.1, try_alsa=False)
    try:
        block = np.zeros((2, 4800), np.float32)  # 100 ms
        t0 = time.monotonic()
        for _ in range(5):  # 500 ms of audio into a 100 ms ring
            out.write(block)
        assert time.monotonic() - t0 > 0.25  # back-pressure, near realtime
        time.sleep(0.05)
        assert out.sample_position > 4800
    finally:
        out.close()


def test_pause_resume():
    out = RtOutput(SR, 2, buffer_secs=0.5, try_alsa=False)
    try:
        out.write(np.zeros((2, 9600), np.float32))
        out.pause()
        assert not out.is_running()
        time.sleep(0.05)
        p1 = out.sample_position
        time.sleep(0.15)
        assert out.sample_position == p1  # frozen while paused
        out.resume()
        time.sleep(0.15)
        assert out.sample_position > p1
    finally:
        out.close()


def test_named_device_falls_back():
    out = RtOutput(SR, 2, buffer_secs=0.05, device="no-such-pcm-device")
    try:
        assert not out.uses_alsa
        out.write(np.zeros((2, 256), np.float32))
    finally:
        out.close()
    assert isinstance(rt.list_alsa_devices(), list)


def test_open_with_config():
    out = RtOutput.open_with_config(RtOutputConfig(
        sample_rate=44100, channels=2, buffer_size=8820, try_alsa=False))
    try:
        assert out.sample_rate == 44100 and out.channel_count == 2
        assert out.sample_format in ("f32", "i32", "i16")
        assert out.space_frames() > 0
    finally:
        out.close()


def test_default_output_device_choice(tmp_path, monkeypatch):
    dev = default_output_device(SR, 2)
    try:
        assert isinstance(dev, RtOutput)
    finally:
        dev.close()
    # without the bridge: WAV given a path, else null
    monkeypatch.setattr(rt, "rt_available", lambda: False)
    wav = pbase.default_output_device(SR, 2, path=tmp_path / "x.wav")
    assert isinstance(wav, WavOutput)
    wav.close()
    assert isinstance(pbase.default_output_device(SR, 2), NullOutput)


def test_web_header_equals_jax():
    for rate, ch in ((SR, 2), (44100, 1), (8000, 6)):
        assert _wav_stream_header(rate, ch) == jax_header(rate, ch)


def test_web_serves_written_frames():
    out = WebOutput(SR, 2, port=0, queue_blocks=4)
    try:
        page = urllib.request.urlopen(out.url, timeout=TIMEOUT).read()
        assert b"stream.wav" in page
        block = np.stack([np.linspace(-1, 1, 512, dtype=np.float32),
                          np.linspace(1, -1, 512, dtype=np.float32)])

        def writer():
            for _ in range(4):
                out.write(block)

        th = threading.Thread(target=writer, daemon=True)
        th.start()
        req = urllib.request.urlopen(out.url + "stream.wav", timeout=TIMEOUT)
        hdr = req.read(44)
        assert hdr == _wav_stream_header(SR, 2)
        assert struct.unpack_from("<HHI", hdr, 20) == (3, 2, SR)
        raw = req.read(512 * 2 * 4)
        req.close()
        got = np.frombuffer(raw, np.float32).reshape(-1, 2).T
        np.testing.assert_array_equal(got, block)
        th.join(timeout=TIMEOUT)
        assert out.sample_position >= 512
    finally:
        out.close()
