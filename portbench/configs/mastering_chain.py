"""mastering_chain: 4 looping stereo stems of 180 s on one bus through
gate -> compressor -> delay -> diode distortion -> limiter, 48 kHz stereo.

The numbers live in ``mastering_chain.json``; this module draws the stems
from the seed (on the card when there is one), builds the chain through
the program's public API, names its automation targets, and gives its
plain reference (``reference/mastering.py``) and the shapes of the
kernels' operations per block.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from reference.mastering import MasteringReference

CONFIG = json.loads(Path(__file__).with_suffix(".json").read_text())
# what a rehearsal on the CPU shrinks (rehearse.py, the tests)
CPU_REHEARSAL = {"stem_seconds": 6.0}


def spec(seed: int) -> dict:
    """The chain's settings and each stem's partials and level envelope,
    drawn from ``seed``."""
    c = CONFIG
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x3A57])
    lv = c["stem_level_db"]
    env = {"rate": float(rng.uniform(*lv["rate_hz"])),
           "phase": float(rng.uniform(0, 2 * math.pi))}
    lo, hi = np.log(c["stem_partial_hz"])
    stems = [{"freqs": np.exp(rng.uniform(lo, hi, c["stem_partials"])).tolist(),
              "amps": rng.uniform(0.1, 1.0, c["stem_partials"]).tolist(),
              "phases": rng.uniform(0, 2 * math.pi,
                                    (2, c["stem_partials"])).tolist(),
              "offset_db": float(rng.uniform(*lv["stem_offset_db"]))}
             for _ in range(c["stems"])]
    return {"sample_rate": c["sample_rate"], "seconds": c["stem_seconds"],
            "stems": stems, "level": dict(lv, **env), "volume": c["volume"],
            **{k: dict(c[k]) for k in ("gate", "comp", "delay", "distortion",
                                       "limiter")}}


_TABLES = {}


def stem_tables(spec: dict) -> list:
    """Every stem's float32 samples [2, frames], made on the card (the CPU
    without one): partials summed under the shared level envelope.  The
    program and the reference read the same samples, made once here."""
    key = json.dumps([spec["stems"], spec["level"], spec["seconds"]])
    if key not in _TABLES:
        _TABLES.clear()
        _TABLES[key] = _make_tables(spec)
    return _TABLES[key]


def _make_tables(spec: dict) -> list:
    sr = spec["sample_rate"]
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    frames = int(round(spec["seconds"] * sr))
    t = torch.arange(frames, dtype=torch.float64, device=dev) / sr
    lv = spec["level"]
    env_db = lv["center"] + lv["swing"] * torch.sin(
        2 * math.pi * lv["rate"] * t + lv["phase"])
    out = []
    for s in spec["stems"]:
        amps = np.asarray(s["amps"]) / np.sum(s["amps"])
        gain = torch.pow(10.0, (env_db + s["offset_db"]) / 20.0)
        chans = []
        for ph in s["phases"]:
            x = torch.zeros_like(t)
            for f, a, p in zip(s["freqs"], amps, ph):
                x += float(a) * torch.sin(2 * math.pi * f * t + p)
            chans.append(x * gain)
        out.append(torch.stack(chans).float().cpu().numpy())
    return out


def knobs(spec: dict, mix: dict) -> list:
    """Automation targets ``(key, pid, low, high)``: the compressor's
    threshold, the delay's wet and the distortion's drive; lanes also the
    gate's and the limiter's thresholds."""
    out = [("comp", "thrs", -24.0, -6.0), ("delay", "wet_", 0.1, 0.5),
           ("dist", "driv", 0.5, 2.0)]
    if mix["entry"] == "lanes":
        out += [("gate", "thrs", -50.0, -30.0),
                ("limiter", "thrs", -3.0, -0.01)]
    return out


def lane_start(spec: dict, rng) -> list:
    """The events a lane of a batch of masters starts with, at frame 0:
    every stem seeks to the lane's own offset (one passage of the song),
    and the lane's own gate, compressor and limiter thresholds and
    distortion drive."""
    frames = int(round(spec["seconds"] * spec["sample_rate"]))
    at = float(rng.integers(0, frames))
    out = [("seek", f"src{i}", None, 0, at, 0.0)
           for i in range(len(spec["stems"]))]
    for key, pid, lo, hi in knobs(spec, {"entry": "lanes"}):
        out.append(("set", key, pid, 0, float(rng.uniform(lo, hi)), 0.0))
    return out


def _nodes(spec: dict, tables: list):
    from phonic_tpu_torch import (AudioFileBuffer, CompressorEffect,
                                  DelayEffect, DistortionEffect,
                                  FilePlaybackOptions, GateEffect)
    sr = spec["sample_rate"]
    sources = [(AudioFileBuffer.from_array(t, sr),
                FilePlaybackOptions(volume=spec["volume"], repeat=None),
                f"src{i}") for i, t in enumerate(tables)]
    g, c, d, x, lim = (spec[k] for k in ("gate", "comp", "delay",
                                          "distortion", "limiter"))
    effects = [
        GateEffect(threshold=g["threshold"], attack=g["attack"],
                   hold=g["hold"], release=g["release"],
                   range_db=g["range_db"], name="gate"),
        CompressorEffect(threshold=c["threshold"], ratio=c["ratio"],
                         knee=c["knee"], attack=c["attack"],
                         release=c["release"], makeup_gain=c["makeup_gain"],
                         lookahead=c["lookahead"], name="comp"),
        DelayEffect(delay_ms=d["delay_ms"], feedback=d["feedback"],
                    wet=d["wet"], width=d["width"],
                    filter_cutoff=d["filter_cutoff"],
                    min_delay_ms=d["min_delay_ms"],
                    max_delay_capacity_ms=d["max_delay_capacity_ms"],
                    name="delay"),
        DistortionEffect(x["type"], drive=x["drive"], mix=x["mix"],
                         name="dist"),
        CompressorEffect.limiter(threshold=lim["threshold"],
                                 attack=lim["attack"],
                                 release=lim["release"], name="limiter")]
    return sources, effects


def build_program(spec: dict, block_frames: int, device, tables=None):
    """A one-instance ``RenderProgram`` of the chain and its nodes by key."""
    from phonic_tpu_torch import EngineConfig, FileSource, Mixer, RenderProgram
    sources, effects = _nodes(spec, tables or stem_tables(spec))
    main = Mixer("main")
    nodes = {}
    for buf, opts, name in sources:
        nodes[name] = main.add_source(FileSource(buf, opts, name=name))
    for e in effects:
        nodes[e.name] = main.add_effect(e)
    cfg = EngineConfig(sample_rate=spec["sample_rate"],
                       block_frames=block_frames, device=device)
    return RenderProgram(main, cfg, device=device), nodes


def reference(spec: dict, lanes: int, block_frames: int, device, dtype,
              player: bool = False, tables=None):
    """The plain reference render (``reference/mastering.py``)."""
    return MasteringReference(spec, tables or stem_tables(spec), lanes,
                              block_frames, device, dtype)


def kernel_ops(spec: dict, lanes: int, block_frames: int) -> dict:
    """Each kernel's operations in one block, from the chain's shapes:
    ``ramp_read`` reads each stem's span of the block once per lane (the
    lanes play other passages), ``iir2`` runs the delay's feedback SVF over
    each sub-block of the lanes' two channels."""
    n = block_frames
    frames = int(round(spec["seconds"] * spec["sample_rate"]))
    stems = len(spec["stems"])
    span = stems * min(frames + 1, lanes * (n + 3))
    sub = 1 << int(math.log2(spec["delay"]["min_delay_ms"]
                             * spec["sample_rate"] / 1000.0 - 1))
    sub = math.gcd(min(sub, 8192), n)
    return {
        "ramp_read": [{"rows": lanes * stems, "n": n, "channels": 2,
                       "table_frames": span}],
        "iir2": [{"rows": 2 * lanes, "coef_rows": lanes, "n": sub}]
        * (n // sub),
    }
