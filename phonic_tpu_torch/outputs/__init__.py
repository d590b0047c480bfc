from .base import OutputDevice
from .null import NullOutput
from .wav_out import WavOutput

__all__ = ["OutputDevice", "NullOutput", "WavOutput"]
