"""Multi-channel distortion: 5 waveshapers with RMS gain compensation (port
of ``phonic_tpu/effects/distortion.py``).

Behavioural spec: reference src/effect/distortion.rs — SoftClip (cubic),
HardClip, Diode (Shockley + atan), Fuzz (exp saturate + half-wave rectify),
Fold (wavefolder) (:124-188); drive 0..4 linear-smoothed (step 0.01), mix
exponentially smoothed (inertia 0.1); RMS compensation from a host-built
256-entry LUT per type, probed with a 5-partial test signal (:84-121).

Memoryless and elementwise: all five shapes evaluate and each lane selects
its own by its type parameter.  The compensation LUT is static: built once
with NumPy on the host and kept per device, outside the render state.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from ..graph.nodes import BuildCtx, Effect
from ..params import EnumParameter, FloatParameter, format_percent

MAX_DRIVE = 4.0
_LUT_SIZE = 256

DIST_TYPE = EnumParameter(
    "type", "Type", ("SoftClip", "HardClip", "Diode", "Fuzz", "Fold"), "Diode"
)
DRIVE = FloatParameter(
    "driv", "Drive", 0.0, MAX_DRIVE, 0.0, unit="x", smoothing="linear",
    smoothing_arg=0.01,
)
MIX = FloatParameter(
    "mix ", "Mix", 0.0, 1.0, 1.0, formatter=format_percent,
    smoothing="exponential", smoothing_arg=0.1,
)


def soft_clip(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + t * t * (15.0 - 1.0)
    xg = x * gain
    shaped = 1.5 * (xg - xg ** 3 / 3.0)
    shaped = torch.where(gain <= 1.0, x, shaped)
    return torch.where(xg >= 1.0, 1.0, torch.where(xg > -1.0, shaped, -1.0))


def hard_clip(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + t * t * (25.0 - 1.0)
    thr = 1.0 / gain
    return torch.clamp(x, -thr, thr) * gain


def diode(x, drive):
    t = drive / MAX_DRIVE
    curve = 0.6 * t * t + 0.4 * t
    gain = 1.0 + curve * (20.0 - 1.0)
    d = torch.exp((0.1 * x) / (0.0253 * 1.68)) - 1.0
    return 2.0 / math.pi * torch.atan(d * gain)


def fuzz(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + (1.0 - torch.exp(-3.0 * t)) * (30.0 - 1.0)
    amp = x * gain
    sat = torch.sign(amp) * (1.0 - torch.exp(-torch.abs(amp)))
    # the reference treats exactly 0 as the positive branch
    sat = torch.where(amp == 0.0, 0.0, sat)
    return 1.5 * (sat + torch.abs(sat))


def fold(x, drive):
    t = drive / MAX_DRIVE
    gain = 1.0 + t * t * (4.0 - 1.0)
    xg = x * gain
    thr = 1.0 / gain
    # floor-mod, as jnp.mod (torch.fmod would truncate)
    folded = torch.abs(torch.remainder(torch.abs(xg - thr), thr * 4.0)
                       - thr * 2.0) - thr
    return torch.where(torch.abs(xg) > thr, folded, xg)


SHAPERS = (soft_clip, hard_clip, diode, fuzz, fold)


def _np_shapers(sig, d):
    """NumPy twins of the five waveshapers, vectorised over drive."""
    t = d / MAX_DRIVE  # [D, 1]
    x = sig[None, :]  # [1, n]
    out = np.empty((len(SHAPERS), len(d), sig.shape[0]), np.float64)
    # soft clip
    gain = 1.0 + t * t * 14.0
    xg = x * gain
    shaped = np.where(gain <= 1.0, x, 1.5 * (xg - xg**3 / 3.0))
    out[0] = np.where(xg >= 1.0, 1.0, np.where(xg > -1.0, shaped, -1.0))
    # hard clip
    gain = 1.0 + t * t * 24.0
    out[1] = np.clip(x, -1.0 / gain, 1.0 / gain) * gain
    # diode
    curve = 0.6 * t * t + 0.4 * t
    gain = 1.0 + curve * 19.0
    out[2] = 2.0 / math.pi * np.arctan((np.exp((0.1 * x) / (0.0253 * 1.68)) - 1.0) * gain)
    # fuzz
    gain = 1.0 + (1.0 - np.exp(-3.0 * t)) * 29.0
    amp = x * gain
    sat = np.where(amp == 0.0, 0.0, np.sign(amp) * (1.0 - np.exp(-np.abs(amp))))
    out[3] = 1.5 * (sat + np.abs(sat))
    # fold
    gain = 1.0 + t * t * 3.0
    xg = x * gain
    thr = 1.0 / gain
    folded = np.abs(np.mod(np.abs(xg - thr), thr * 4.0) - thr * 2.0) - thr
    out[4] = np.where(np.abs(xg) > thr, folded, xg)
    return out


def _build_luts():
    """[5, 256] input_rms/output_rms per (type, drive), probed with the
    reference's 5-partial signal (distortion.rs:84-121)."""
    partials = [(1.0, 0.60), (2.7, 0.25), (5.3, 0.10), (9.1, 0.03), (14.6, 0.02)]
    peak = sum(a for _, a in partials)
    n = 256
    t = 2.0 * math.pi * (np.arange(n) + 0.5) / n
    sig = (sum(a * np.sin(f * t) for f, a in partials) / peak).astype(np.float32)
    in_rms = float(np.sqrt(np.mean(sig.astype(np.float64) ** 2)))
    drives = (np.arange(_LUT_SIZE) / (_LUT_SIZE - 1) * MAX_DRIVE)[:, None]
    shaped = _np_shapers(sig, drives)  # [5, D, n]
    orms = np.sqrt(np.mean(shaped**2, axis=-1))  # [5, D]
    luts = np.where(orms > 1e-10, in_rms / np.maximum(orms, 1e-10), 1.0)
    return luts.astype(np.float32)


@lru_cache(maxsize=None)
def compensation_luts(device: torch.device) -> torch.Tensor:
    """The [5, 256] float32 compensation LUT on ``device``."""
    return torch.as_tensor(_build_luts(), device=device)


class DistortionEffect(Effect):
    PARAMS = (DIST_TYPE, DRIVE, MIX)
    WEIGHT = 1

    def __init__(self, distortion_type: str = "Diode", drive: float = 0.0,
                 mix: float = 1.0, name=None):
        super().__init__(name)
        self.distortion_type = distortion_type
        self.drive = float(drive)
        self.mix = float(mix)

    def param_initials(self):
        return {
            DIST_TYPE.id: DIST_TYPE.index_of(self.distortion_type),
            DRIVE.id: self.drive,
            MIX.id: self.mix,
        }

    def batch_key(self, ctx: BuildCtx):
        # process() reads no per-instance statics
        return (type(self).__name__,)

    def process(self, state, x, params, ctx: BuildCtx):
        kind = params[DIST_TYPE.id][:, 0].to(torch.int64)  # [G]
        drive = params[DRIVE.id]  # [G, n]
        mix = params[MIX.id][:, None, :]

        pos = torch.clamp(drive / MAX_DRIVE, 0.0, 1.0) * (_LUT_SIZE - 1)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.clamp(lo + 1, max=_LUT_SIZE - 1)
        frac = pos - lo
        lut = compensation_luts(x.device)[kind]  # [G, 256]
        c_lo = torch.gather(lut, 1, lo)
        comp = c_lo + (torch.gather(lut, 1, hi) - c_lo) * frac

        shaped = torch.stack([f(x, drive[:, None, :]) for f in SHAPERS], dim=1)
        lanes = torch.arange(x.shape[0], device=x.device)
        wet = shaped[lanes, kind] * comp[:, None, :]
        y = (1.0 - mix) * x + mix * wet
        return state, y
