"""Engine error types (behavioural spec: reference src/error.rs:8-23)."""

from __future__ import annotations


class PhonicError(Exception):
    """Base class for all engine errors."""


class MediaFileError(PhonicError):
    """File could not be opened/decoded (reference: Error::MediaFileError)."""


class UnsupportedFormatError(MediaFileError):
    """Container/codec has no registered decoder."""


class OutputDeviceError(PhonicError):
    """Audio output device failure (reference: Error::OutputDeviceError)."""


class ResamplingError(PhonicError):
    """Resampler misconfiguration (reference: Error::ResamplingError)."""


class NotFoundError(PhonicError):
    """Unknown playback/mixer/effect id (reference: Error::*NotFound)."""


class ParameterError(PhonicError):
    """Invalid parameter value or id (reference: Error::ParameterError)."""


class SendError(PhonicError):
    """Control message could not be delivered (reference: Error::SendError)."""


class CheckpointError(PhonicError):
    """Render-state snapshot does not match the program resuming it
    (no reference analog: checkpointing is beyond the reference's scope)."""
