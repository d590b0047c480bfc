from .decoder import (
    AudioFileBuffer,
    AudioFileInfo,
    decode_file,
    file_info,
    register_decoder,
)
from .wav import read_wav, read_wav_info, write_wav, LoopInfo, WavInfo

__all__ = [
    "AudioFileBuffer", "AudioFileInfo", "decode_file", "file_info",
    "register_decoder", "read_wav", "read_wav_info", "write_wav",
    "LoopInfo", "WavInfo",
]
