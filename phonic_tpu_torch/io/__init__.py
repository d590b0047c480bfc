from .decoder import AudioFileBuffer

__all__ = ["AudioFileBuffer"]
