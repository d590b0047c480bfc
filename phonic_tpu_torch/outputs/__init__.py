from .base import OutputDevice, default_output_device
from .null import NullOutput
from .wav_out import WavOutput
from .rt import RtOutput, rt_available, alsa_available
from .web import WebOutput

__all__ = ["OutputDevice", "default_output_device", "NullOutput", "WavOutput",
           "RtOutput", "rt_available", "alsa_available", "WebOutput"]
