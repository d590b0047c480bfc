"""Output device protocol (copy of ``phonic_tpu/outputs/base.py``).

Behavioural spec: reference src/output.rs — `OutputDevice` with
channel_count / sample_rate / sample_position / volume / pause / resume /
play / stop / close; `default_output_device` selected by availability
(reference picks CPAL, WAV or Web by feature flags, src/output.rs:23-27).

Devices consume rendered blocks: the device *receives* planar blocks
instead of pulling inside an OS callback; the native bridge (outputs/rt.py
+ csrc/ringbuf.cpp) restores pull semantics at the hardware edge with a
lock-free ring buffer.
"""

from __future__ import annotations

import abc

import numpy as np

from ..config import DEFAULT_INERTIA, SMOOTHER_EPSILON, SMOOTHER_REFERENCE_SR


class OutputDevice(abc.ABC):
    # device-edge master volume (reference: OutputDevice::volume,
    # src/output.rs:51; the CPAL callback applies it as a smoothed gain,
    # src/output/cpal.rs:717-720).  Exponential-smoother semantics match
    # ops/smoothing.py (inertia 1/256, 44.1 kHz rate compensation, snap at
    # epsilon); concrete outputs apply it via _apply_volume in write().
    _volume_target = 1.0
    _volume_current = 1.0

    @property
    def volume(self) -> float:
        return self._volume_target

    def set_volume(self, volume: float) -> None:
        self._volume_target = max(float(volume), 0.0)

    def _apply_volume(self, block):
        """Smoothed master gain over one planar [ch, n] block."""
        tgt, cur = self._volume_target, self._volume_current
        if cur == tgt:
            return block if tgt == 1.0 else np.asarray(block) * np.float32(tgt)
        n = np.shape(block)[-1]
        alpha = DEFAULT_INERTIA * SMOOTHER_REFERENCE_SR / float(self.sample_rate)
        # closed form of current += alpha * (target - current) per sample;
        # the snap checks the PRE-step delta, like the reference's next()
        i = np.arange(n, dtype=np.float64)
        pre = (cur - tgt) * np.power(1.0 - alpha, i)
        g = tgt + pre * (1.0 - alpha)
        g = np.where(alpha * np.abs(pre) <= SMOOTHER_EPSILON, tgt, g)
        self._volume_current = float(g[-1])
        return np.asarray(block) * g.astype(np.float32)[None, :]

    @property
    @abc.abstractmethod
    def sample_rate(self) -> int: ...

    @property
    @abc.abstractmethod
    def channel_count(self) -> int: ...

    @property
    @abc.abstractmethod
    def sample_position(self) -> int:
        """Frames actually emitted so far (reference: src/output.rs:44)."""

    @abc.abstractmethod
    def write(self, block) -> None:
        """Accept one planar float32 [channels, frames] block (may bloc
        until the device has room)."""

    _paused = False

    def pause(self) -> None:
        self._paused = True

    def resume(self) -> None:
        self._paused = False

    def is_running(self) -> bool:
        """Playback not paused (reference: OutputDevice::is_running)."""
        return not self._paused

    @abc.abstractmethod
    def close(self) -> None: ...



def default_output_device(sample_rate: int = 48000, channels: int = 2,
                          path=None) -> OutputDevice:
    """DefaultOutputDevice analog: the realtime native device when its
    backend is available, else WAV (when a path is given), else null."""
    from .rt import RtOutput, rt_available
    if rt_available():
        return RtOutput(sample_rate, channels)
    if path is not None:
        from .wav_out import WavOutput
        return WavOutput(path, sample_rate, channels)
    from .null import NullOutput
    return NullOutput(sample_rate, channels)
