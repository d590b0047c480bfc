"""Per-voice modulation matrix (port of ``phonic_tpu/modulation/matrix.py``).

Behavioural spec: reference src/modulation/ — sources LFO1/LFO2 (bipolar,
rate 0.01-20 Hz + waveform), VELOCITY and KEYTRACK (unipolar, note/127)
(src/generator/sampler.rs:362-427); routing accumulates with polarity
transforms (src/modulation/matrix.rs:196-246): bipolar->unipolar maps
(v+1)/2, unipolar->bipolar maps (v-0.5)*2, matching polarities pass through;
each routing scales by its amount.

Routings live in a dense ``amounts[S, T]`` + ``bipolar[S, T]`` pair that
each block lowers, so editing them needs no rebuild.  LFO phases are
analytic functions of the note age (they restart at note-on), so the matrix
carries no state.  Every function takes leading voice dimensions: the
sampler evaluates all of its voices at once over ``[V, n]`` ages.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import ahdsr as ahdsr_ops
from ..ops import lfo as lfo_ops
from ..ops.precision import recip32
from . import config as cfg_mod

SOURCES = ("LFO1", "LFO2", "VELM", "KEYM")
SOURCE_BIPOLAR = (True, True, False, False)

# the 7 modulatable granular targets (src/generator/sampler/modulation.rs)
TARGETS = ("GSIZ", "GDEN", "GVAR", "GSPY", "GPAN", "GPOS", "GSTP")


class ModulationRoutings:
    """Host-side routing table -> dense arrays.  Sized by a
    ModulationConfig (modulation/config.py); defaults to the sampler's
    stock LFO1/LFO2/VELM/KEYM -> 7 granular targets."""

    def __init__(self, config=None):
        if config is None:
            config = cfg_mod.default_sampler_config()
        self.config = config
        self.source_ids = list(config.source_ids)
        self.target_ids = list(config.targets)
        self.amounts = np.zeros(
            (len(self.source_ids), len(self.target_ids)), np.float32)
        self.bipolar = np.zeros_like(self.amounts)

    def _index(self, source: str, target: str):
        if source not in self.source_ids:
            raise KeyError(f"unknown modulation source {source!r}; "
                           f"have {self.source_ids}")
        if target not in self.target_ids:
            raise KeyError(f"unknown modulation target {target!r}; "
                           f"have {self.target_ids}")
        return self.source_ids.index(source), self.target_ids.index(target)

    def set(self, source: str, target: str, amount: float, bipolar: bool = True):
        s, t = self._index(source, target)
        self.amounts[s, t] = amount
        self.bipolar[s, t] = 1.0 if bipolar else 0.0

    def clear(self, source: str, target: str):
        s, t = self._index(source, target)
        self.amounts[s, t] = 0.0

    def clear_all(self):
        self.amounts[:] = 0.0


def _lfo(inc, wf, agef, seed):
    """An LFO waveform at phase ``age * inc`` (restarting at note-on)."""
    raw = agef * inc
    wraps = torch.floor(raw)
    return _waveform_at(wf, raw - wraps, wraps.to(torch.int32), seed)


def source_values(age, velocity, note, lfo1_inc, lfo1_wf, lfo2_inc, lfo2_wf,
                  n: int, seed=0):
    """[..., S, n] source values of the stock layout.  ``age`` int [..., n] =
    runs since note-on; velocity / note broadcast against it; ``seed`` an
    int or a tensor that broadcasts against ``age``."""
    agef = torch.clamp(age.to(torch.float32), min=0.0)
    shape = agef.shape[:-1] + (n,)
    return torch.stack([
        _lfo(lfo1_inc, lfo1_wf, agef, seed + 0x11),
        _lfo(lfo2_inc, lfo2_wf, agef, seed + 0x22),
        torch.as_tensor(velocity, dtype=torch.float32).expand(shape),
        (torch.as_tensor(note, dtype=torch.float32) * recip32(127.0)
         ).expand(shape),
    ], dim=-2)


def _waveform_at(wf, phase, wraps, seed):
    """Evaluate an LFO waveform at explicit phases (the formulas of
    ops/lfo.lfo_block).  ``wf`` is a waveform id (int or 0-d tensor) and
    every waveform is computed, so a device id needs no host read."""
    tau = 2.0 * math.pi
    sine = lfo_ops.sine_approx(torch.where(phase < 0.5, phase * tau,
                                           (phase - 1.0) * tau))
    triangle = torch.where(
        phase < 0.25, phase * 4.0,
        torch.where(phase < 0.75, 2.0 - phase * 4.0, phase * 4.0 - 4.0))
    ramp_up = phase * 2.0 - 1.0
    ramp_down = 1.0 - phase * 2.0
    square = torch.where(phase < 0.5, 1.0, -1.0)
    random = lfo_ops._hash_random(seed, wraps)
    t = (1.0 - lfo_ops.sine_approx(math.pi / 2.0 - phase * math.pi)) * 0.5
    smooth = random + t * (lfo_ops._hash_random(seed, wraps.to(torch.int64) + 1)
                           - random)
    stacked = torch.stack([sine, triangle, ramp_up, ramp_down, square, random,
                           smooth])
    idx = torch.clamp(torch.as_tensor(wf, device=phase.device).to(torch.int64),
                      0, 6)
    if idx.numel() > 1:  # one id per row ([R, 1], per-row parameters)
        return torch.gather(stacked, 0, idx.expand(phase.shape)[None])[0]
    return torch.index_select(stacked, 0, idx.reshape(1))[0]


def build_source_specs(config, params, sample_rate):
    """Per-block payloads for each configured source.  ``params`` maps
    parameter ids to per-sample values ``[n]``, or ``[R, n]`` with a row per
    voice (the block's first value is used: a scalar, or ``[R, 1]``).
    Returns a list of (kind, payload) consumed by :func:`eval_sources`."""
    def first(x):
        return x[0] if x.dim() == 1 else x[:, :1]

    specs = []
    lfo_slot = 0
    for s in config.sources:
        if isinstance(s, cfg_mod.LfoSource):
            lfo_slot += 1
            inc = first(params[s.rate_param]) * recip32(sample_rate)
            wf = first(params[s.wave_param]).to(torch.int32)
            specs.append(("lfo", (inc, wf, 0x11 * lfo_slot)))
        elif isinstance(s, cfg_mod.EnvelopeSource):
            p = s.prefix
            e0 = lambda c: first(params[p + c])
            env_p = ahdsr_ops.ahdsr_params(
                sample_rate, e0("A"), e0("H"), e0("D"), e0("S"), e0("R"))
            specs.append(("env", env_p))
        elif isinstance(s, cfg_mod.VelocitySource):
            specs.append(("vel", None))
        elif isinstance(s, cfg_mod.KeytrackingSource):
            specs.append(("key", None))
        else:
            raise TypeError(f"unknown modulation source {s!r}")
    return specs


def eval_sources(specs, age, velocity, note, release_at, n: int, seed=0):
    """[..., S, n] source values for an arbitrary config.

    age: int [..., n] runs since note-on (handles in-block retriggers);
    velocity, note: broadcast against ``age``; release_at: the age at
    note-off (inf = held) for envelopes; seed: an int, or a tensor of
    per-voice seeds that broadcasts against ``age`` (``[V, 1]``)."""
    agef = torch.clamp(age.to(torch.float32), min=0.0)
    shape = agef.shape[:-1] + (n,)
    vals = []
    for kind, payload in specs:
        if kind == "lfo":
            inc, wf, salt = payload
            vals.append(_lfo(inc, wf, agef, seed + salt))
        elif kind == "env":
            # envelope scales by the note velocity, like the reference's
            # matrix.note_on(note, volume) (src/modulation/processor.rs:134)
            vals.append(ahdsr_ops.ahdsr_values(payload, velocity, age,
                                               release_at).expand(shape))
        elif kind == "vel":
            vals.append(torch.as_tensor(velocity, dtype=torch.float32)
                        .expand(shape))
        else:  # key
            vals.append((torch.as_tensor(note, dtype=torch.float32)
                         * recip32(127.0)).expand(shape))
    return torch.stack(vals, dim=-2)


def source_polarity(config):
    """[S] 1.0 where the source is bipolar."""
    return np.asarray([1.0 if s.bipolar else 0.0 for s in config.sources],
                      np.float32)


def apply_matrix(sources, amounts, bipolar, src_bipolar=None):
    """sources [..., S, n] -> target offsets [..., T, n] with polarity
    transforms.  ``amounts`` / ``bipolar`` [S, T] or [..., S, T] (per row;
    tensors on the sources' device, or arrays); ``src_bipolar``: [S] host
    source polarities
    (default: the stock LFO1/LFO2/VELM/KEYM layout).  The sum over sources
    runs in source order, as the JAX package's reduction does."""
    if src_bipolar is None:
        src_bipolar = SOURCE_BIPOLAR
    dev = sources.device
    amounts = torch.as_tensor(amounts, dtype=torch.float32, device=dev)
    tgt_bip = torch.as_tensor(bipolar, dtype=torch.float32, device=dev) > 0.5
    out = None
    for s, src_bip in enumerate(src_bipolar):
        x = sources[..., s, None, :]  # [..., 1, n]
        tb = tgt_bip[..., s, :, None]  # [..., T, 1]
        # four polarity cases (matrix.rs:196-246)
        if src_bip > 0.5:
            v = torch.where(tb, x, (x + 1.0) * 0.5)
        else:
            v = torch.where(tb, (x - 0.5) * 2.0, x)
        term = v * amounts[..., s, :, None]
        out = term if out is None else out + term
    return out
