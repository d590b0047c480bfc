"""BASELINE config 1, play a file, and the offline render of a decoded file.

``play_file_graph`` is the JAX package's benchmark configuration
``config_play_file`` (bench.py): one 48000-frame mono tone at 220 Hz,
played endlessly at volume 0.8, panning 0.2 and speed 1.09 through the
default (Hermite) read, at 48 kHz stereo in 262144-frame blocks.  The
source is named so that its node path, and with it its render state,
lines up between the two packages.

``render_file`` is the mixdown of one file that users run offline: decode
it, play it once through a file source, render to the graph's natural
length and write a 32-bit float WAV.
"""

from __future__ import annotations

from typing import Optional

from .config import EngineConfig
from .graph.engine import RenderProgram
from .graph.mixer import Mixer
from .headline import SAMPLE_RATE, tone
from .io.decoder import AudioFileBuffer
from .outputs.wav_out import WavOutput
from .sources.file import FilePlaybackOptions, FileSource

BLOCK_FRAMES = 262144


def file_program(buffer: AudioFileBuffer,
                 options: Optional[FilePlaybackOptions] = None,
                 block_frames: int = BLOCK_FRAMES, device=None) -> RenderProgram:
    """One file source named ``file`` under the master mixer, as a program
    at 48 kHz stereo on the config's device, the CUDA card, unless
    ``device`` says otherwise."""
    main = Mixer("main")
    main.add_source(FileSource(buffer, options, name="file"))
    config = EngineConfig(sample_rate=SAMPLE_RATE, block_frames=block_frames)
    return RenderProgram(main, config, device=device)


def play_file_graph() -> Mixer:
    main = Mixer("main")
    main.add_source(FileSource(tone(), FilePlaybackOptions(
        volume=0.8, panning=0.2, speed=1.09, repeat=None), name="file"))
    return main


def play_file_program(block_frames: int = BLOCK_FRAMES,
                      device=None) -> RenderProgram:
    """Config 1 as a program at 48 kHz stereo, on the CUDA card unless
    ``device`` says otherwise."""
    config = EngineConfig(sample_rate=SAMPLE_RATE, block_frames=block_frames)
    return RenderProgram(play_file_graph(), config, device=device)


def render_file(path, out_path, options: Optional[FilePlaybackOptions] = None,
                block_frames: int = BLOCK_FRAMES, device=None) -> int:
    """Decode ``path``, render it through :func:`file_program` to its
    natural length (the options must make it finite: ``repeat`` not None)
    and write the result to ``out_path`` as a 32-bit float WAV at 48 kHz.
    Returns the number of frames written."""
    prog = file_program(AudioFileBuffer.from_file(path), options,
                        block_frames, device)
    audio = prog.render()
    out = WavOutput(out_path, SAMPLE_RATE, prog.ctx.channels)
    try:
        out.write(audio)
    finally:
        out.close()
    return audio.shape[-1]
