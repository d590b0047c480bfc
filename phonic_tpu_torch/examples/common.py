"""Shared example plumbing (port of ``examples/common.py``; reference:
examples/common/arguments.rs): every example takes ``-o out.wav`` to render
offline instead of playing on the realtime device, making any scenario a
deterministic fixture, and ``--device`` for the torch device it renders on
(the CUDA card by default)."""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..io.decoder import AudioFileBuffer
from ..outputs import NullOutput, RtOutput, WavOutput, rt_available
from ..player import Player, PlayerConfig


def make_parser(description: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("-o", "--output", default=None,
                   help="render offline to this WAV file instead of playing")
    p.add_argument("--sample-rate", type=int, default=48000)
    p.add_argument("--block", type=int, default=8192)
    p.add_argument("--device", dest="torch_device", default="cuda",
                   help="torch device to render on (default: cuda)")
    return p


def make_output(args):
    """WAV when rendering offline, else the realtime device when its bridge
    builds, else a realtime-paced null sink."""
    if args.output:
        return WavOutput(args.output, args.sample_rate, 2)
    if rt_available():
        return RtOutput(args.sample_rate, 2)
    return NullOutput(args.sample_rate, 2, realtime=True)


def make_player(args, output=None) -> Player:
    return Player(output or make_output(args),
                  PlayerConfig(block_frames=args.block),
                  device=args.torch_device)


def demo_buffer(sr=48000, freq=220.0, secs=1.0, decay=3.0) -> AudioFileBuffer:
    """Synthetic test tone (the examples ship no binary assets)."""
    t = np.arange(int(sr * secs)) / sr
    x = 0.5 * np.sin(2 * np.pi * freq * t) * np.exp(-t * decay)
    x += 0.2 * np.sin(2 * np.pi * freq * 2.01 * t) * np.exp(-t * decay * 1.5)
    return AudioFileBuffer.from_array(x.astype(np.float32)[None, :], sr)


def default_asset(name="bass.wav", sr=48000, secs=1.0):
    """A real-world asset from the directory named by ``PHONIC_ASSETS``
    (the reference examples' assets) when it holds ``name``, else the
    synthetic tone."""
    path = os.path.join(os.environ.get("PHONIC_ASSETS", ""), name)
    return path if os.path.isfile(path) else demo_buffer(sr, secs=secs)
