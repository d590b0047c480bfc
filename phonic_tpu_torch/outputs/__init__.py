from .base import OutputDevice
from .wav_out import WavOutput

__all__ = ["OutputDevice", "WavOutput"]
