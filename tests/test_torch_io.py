"""File decoding in the port (phonic_tpu_torch/io/) against the JAX
package's decoders.

Every input is built in the test: WAVs by the writer (and 8-bit and
float64 PCM by hand), IMA / MS ADPCM by the encoders of test_adpcm.py, AIFF
by hand, FLAC and ALAC by the JAX package's fixture encoders.  Both
packages decode each file and the arrays must be equal exactly; so must
``file_info`` and ``AudioFileBuffer.from_file`` (loop range and mode from a
``smpl`` chunk).  The port's native FLAC / ALAC decoder (csrc/flacdec.cpp,
built with g++ at first use) must decode exactly as the port's pure-Python
frame decoder.
"""

import struct

import numpy as np
import pytest

from phonic_tpu.io import decoder as jdecoder, wav as jwav
from phonic_tpu.io.alac import write_alac
from phonic_tpu.io.flac import write_flac
from phonic_tpu_torch import errors as perrors
from phonic_tpu_torch.io import alac as palac, decoder as pdecoder, flac as pflac
from phonic_tpu_torch.io import mp3 as pmp3, vorbis as pvorbis, wav as pwav
from test_adpcm import _encode_ima, _encode_ms, _sine
from test_chunked import _f80

SR = 44100


def _signal(frames, ch=2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(frames) / SR
    f = rng.uniform(100.0, 3000.0, (ch, 3, 1))
    x = 0.3 * np.sin(2 * np.pi * f * t).sum(axis=1)
    return (x + 0.01 * rng.standard_normal((ch, frames))).astype(np.float32)


def _pcm8(path, x):
    body = np.clip(np.round(x.T * 127.0 + 128.0), 0, 255).astype(np.uint8)
    path.write_bytes(jwav.wav_header(SR, x.shape[0], 8, False, body.size)
                     + body.tobytes())


def _float64(path, x):
    body = np.ascontiguousarray(x.T, "<f8").tobytes()
    fmt = struct.pack("<HHIIHH", 3, x.shape[0], SR, SR * x.shape[0] * 8,
                      x.shape[0] * 8, 64)
    chunks = (b"fmt " + struct.pack("<I", len(fmt)) + fmt
              + b"data" + struct.pack("<I", len(body)) + body)
    path.write_bytes(b"RIFF" + struct.pack("<I", 4 + len(chunks)) + b"WAVE"
                     + chunks)


def _aiff(path, x, bits):
    dtype = {16: ">i2", 32: ">i4"}[bits]
    ints = np.round(x.T * (2.0 ** (bits - 1) - 1)).astype(dtype)
    comm = struct.pack(">hIh", x.shape[0], x.shape[1], bits) + _f80(SR)
    ssnd = struct.pack(">II", 0, 0) + ints.tobytes()
    chunks = (b"COMM" + struct.pack(">I", len(comm)) + comm
              + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    path.write_bytes(b"FORM" + struct.pack(">I", 4 + len(chunks)) + b"AIFF"
                     + chunks)


def _with_smpl(path, start, end, mode):
    raw = path.read_bytes()
    smpl = struct.pack("<9I", 0, 0, 1000000000 // SR, 60, 0, 0, 0, 1, 0)
    smpl += struct.pack("<6I", 0, mode, start, end, 0, 0)
    chunk = b"smpl" + struct.pack("<I", len(smpl)) + smpl
    path.write_bytes(raw[:4] + struct.pack("<I", len(raw) - 8 + len(chunk))
                     + raw[8:] + chunk)


MAKERS = {
    "pcm8": ("wav", _pcm8),
    "pcm16": ("wav", lambda p, x: jwav.write_wav(p, x, SR, 16, False)),
    "pcm24": ("wav", lambda p, x: jwav.write_wav(p, x, SR, 24, False)),
    "pcm32": ("wav", lambda p, x: jwav.write_wav(p, x, SR, 32, False)),
    "float32": ("wav", lambda p, x: jwav.write_wav(p, x, SR)),
    "float64": ("wav", _float64),
    "ima_adpcm": ("wav", lambda p, x: p.write_bytes(
        _encode_ima((x * 32767).astype(np.int16), SR))),
    "ms_adpcm": ("wav", lambda p, x: p.write_bytes(
        _encode_ms((x * 32767).astype(np.int16), SR))),
    "aiff16": ("aiff", lambda p, x: _aiff(p, x, 16)),
    "aiff32": ("aiff", lambda p, x: _aiff(p, x, 32)),
    "flac_lpc_mid_side": ("flac", lambda p, x: write_flac(
        p, x, SR, subframe="lpc2", stereo="mid_side")),
    "flac_fixed_mono": ("flac", lambda p, x: write_flac(
        p, x[:1], SR, subframe="fixed2")),
    "alac_rice": ("m4a", lambda p, x: write_alac(p, x, SR, mode="rice",
                                                 order=4)),
    "alac_order31": ("m4a", lambda p, x: write_alac(p, x, SR,
                                                    mode="order31")),
}


@pytest.mark.parametrize("kind", sorted(MAKERS))
def test_decode_matches_jax(tmp_path, kind):
    ext, make = MAKERS[kind]
    path = tmp_path / f"{kind}.{ext}"
    make(path, _signal(9001))
    want, jinfo = jdecoder.decode_file(path)
    got, info = pdecoder.decode_file(path)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert (info.sample_rate, info.channels, info.frames) == (
        jinfo.sample_rate, jinfo.channels, jinfo.frames)
    jprobe, probe = jdecoder.file_info(path), pdecoder.file_info(path)
    assert (probe.sample_rate, probe.channels, probe.frames, probe.loops) == (
        jprobe.sample_rate, jprobe.channels, jprobe.frames, jprobe.loops)


@pytest.mark.parametrize("mode", [pwav.LOOP_FORWARD, pwav.LOOP_PINGPONG])
def test_buffer_from_file_matches_jax(tmp_path, mode):
    path = tmp_path / "loop.wav"
    pwav.write_wav(path, _signal(5000), SR)
    _with_smpl(path, 700, 4199, mode)
    want = jdecoder.AudioFileBuffer.from_file(path)
    got = pdecoder.AudioFileBuffer.from_file(path)
    assert got.loop_range == want.loop_range == (700, 4200)
    assert got.loop_mode == want.loop_mode
    assert got.sample_rate == want.sample_rate
    assert np.array_equal(got.data, want.data)
    info = pdecoder.file_info(path)
    assert info.loops == [pwav.LoopInfo(mode=mode, start=700, end=4199)]


def test_from_array_matches_jax():
    x = _signal(3000)
    got = pdecoder.AudioFileBuffer.from_array(x, SR, (10, 20), "pingpong")
    want = jdecoder.AudioFileBuffer.from_array(x, SR, (10, 20), "pingpong")
    assert np.array_equal(got.data, want.data)
    assert (got.loop_range, got.loop_mode) == (want.loop_range, want.loop_mode)


def test_native_flac_matches_python(tmp_path, monkeypatch):
    """csrc/flacdec.cpp against the port's Python frame decoder, whole file
    and through the streaming cursor."""
    rng = np.random.default_rng(11)
    x = np.cumsum(rng.integers(-300, 300, size=(2, 50000)), axis=1)
    x = (x / np.abs(x).max() * 0.8).astype(np.float32)
    path = tmp_path / "walk.flac"
    write_flac(path, x, SR, subframe="lpc2", stereo="left_side")
    a, ra = pflac.read_flac(path)
    stream = pflac.FlacStream(path)
    a_part = stream.read_at(12345, 4096)
    stream.close()
    monkeypatch.setattr(pflac, "_decode_frame", pflac._decode_frame_py)
    b, rb = pflac.read_flac(path)
    stream = pflac.FlacStream(path)
    b_part = stream.read_at(12345, 4096)
    stream.close()
    assert ra == rb == SR
    assert np.array_equal(a, b) and np.array_equal(a_part, b_part)


@pytest.mark.parametrize("mode,order", [("rice", 0), ("rice", 8),
                                        ("order31", 0), ("verbatim", 0)])
def test_native_alac_matches_python(tmp_path, monkeypatch, mode, order):
    rng = np.random.default_rng(3)
    x = np.cumsum(rng.integers(-400, 400, size=(2, 10011)), axis=1)
    x = (x / np.abs(x).max() * 0.7).astype(np.float32)
    path = tmp_path / "walk.m4a"
    write_alac(path, x, 48000, mode=mode, order=order)
    a, ra = palac.read_alac(path)
    monkeypatch.setattr(palac, "decode_packet", palac._decode_packet_py)
    b, rb = palac.read_alac(path)
    assert ra == rb == 48000
    assert np.array_equal(a, b)


def test_native_library_builds_under_the_package():
    path = pflac._native_path()
    assert path.is_file() and path.parent.parent.name == "_build"
    assert pflac._native_path() == path  # built once, then reused


def test_register_decoder_dispatch(tmp_path):
    path = tmp_path / "tone.xyz"
    path.write_bytes(b"\x00\x01\x02\x03" + b"\x00" * 64)
    x = _signal(700, ch=1)
    calls = []

    def decode(p):
        calls.append(p)
        return x, 32000

    pdecoder.register_decoder(".XYZ", decode)
    try:
        got, info = pdecoder.decode_file(path)
        buf = pdecoder.AudioFileBuffer.from_file(path)
    finally:
        pdecoder._DECODERS.pop("xyz")
    assert np.array_equal(got, x) and info.sample_rate == 32000
    assert info.frames == 700 and buf.frames == 700 and len(calls) == 2


def test_unknown_format_raises(tmp_path):
    path = tmp_path / "f.alac"
    path.write_bytes(b"\x00\x01\x02\x03" + b"\x00" * 64)
    with pytest.raises(perrors.UnsupportedFormatError,
                       match="phonic_tpu_torch.io.register_decoder"):
        pdecoder.decode_file(path)


def test_mp3_matches_jax_where_available(tmp_path):
    if not pmp3.mp3_available():
        pytest.skip("no libmpg123 on this host")
    from test_mp3_vorbis import _encode_mp3_sine
    path = tmp_path / "sine.mp3"
    _encode_mp3_sine(path, secs=0.5)
    want, jinfo = jdecoder.decode_file(path)
    got, info = pdecoder.decode_file(path)
    assert np.array_equal(got, want) and info.sample_rate == jinfo.sample_rate
    assert pdecoder.file_info(path).frames == jdecoder.file_info(path).frames


def test_vorbis_raises_on_a_corrupt_stream_where_available(tmp_path):
    if not pvorbis.vorbis_available():
        pytest.skip("no libvorbisfile on this host")
    path = tmp_path / "f.ogg"
    path.write_bytes(b"OggS" + b"\x00" * 200)
    with pytest.raises(perrors.MediaFileError):
        pdecoder.decode_file(path)
