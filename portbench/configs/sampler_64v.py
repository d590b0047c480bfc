"""sampler_64v: one 64-voice AHDSR sampler per lane playing a dense note
part on a struck stereo tone, 48 kHz stereo.

The numbers live in ``sampler_64v.json``; this module draws the tone from
the seed (on the card when there is one), builds the sampler through the
program's public API, names its automation targets, adds the note entry
(``harness/notes.py``) to the harness's entries, and gives its plain
reference (``reference/sampler.py``) and the shapes of the kernels'
operations per block.

It needs a port whose sampler renders every note that starts on a voice
in a block, through the voice plan of ``phonic_tpu_torch.generators.plan``;
with an older port the import below fails and the run exits at once.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from phonic_tpu_torch.generators.plan import VoicePlan  # noqa: F401
from harness.entries import ENTRIES
from harness.notes import NotesEntry
from reference.sampler import SamplerReference

CONFIG = json.loads(Path(__file__).with_suffix(".json").read_text())
CPU_REHEARSAL = {}
NOTE_TARGET = "sampler"
ENTRIES.setdefault("lanes_notes", NotesEntry)


def spec(seed: int) -> dict:
    """The sampler's settings and its tone's partials, drawn from
    ``seed``."""
    c, s = CONFIG, CONFIG["sample"]
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x5A3B])
    k = np.arange(1, s["partials"] + 1)
    b = rng.uniform(*s["inharmonicity"])
    d0, growth = rng.uniform(*s["decay_per_s"]), rng.uniform(*s["decay_growth"])
    amps = k ** -rng.uniform(*s["partial_rolloff"]) * rng.uniform(
        0.5, 1.0, s["partials"])
    tone = {"freqs": (s["fundamental_hz"] * k * np.sqrt(1 + b * k * k)).tolist(),
            "amps": (amps / amps.sum()).tolist(),
            "decays": (d0 * (1 + growth * (k - 1))).tolist(),
            "phases": rng.uniform(0, 2 * math.pi,
                                  (s["channels"], s["partials"])).tolist()}
    return {"sample_rate": c["sample_rate"], "voices": c["voices"],
            "envelope": dict(c["envelope"]), "volume": c["volume"],
            "sample": dict(s), "tone": tone}


_TABLES = {}


def sample_table(spec: dict) -> np.ndarray:
    """The tone's float32 samples [channels, frames], made on the card (the
    CPU without one); the program and the reference read the same ones."""
    key = json.dumps([spec["sample"], spec["tone"]])
    if key not in _TABLES:
        _TABLES.clear()
        s, tone = spec["sample"], spec["tone"]
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        t = torch.arange(int(round(s["seconds"] * s["sample_rate"])),
                         dtype=torch.float64, device=dev) / s["sample_rate"]
        strike = 1.0 - torch.exp(-t / s["strike_s"])
        chans = []
        for ph in tone["phases"]:
            x = torch.zeros_like(t)
            for f, a, d, p in zip(tone["freqs"], tone["amps"], tone["decays"],
                                  ph):
                x += a * torch.sin(2 * math.pi * f * t + p) * torch.exp(-d * t)
            chans.append(s["peak"] * strike * x)
        _TABLES[key] = torch.stack(chans).float().cpu().numpy()
    return _TABLES[key]


def knobs(spec: dict, mix: dict) -> list:
    """Automation targets ``(key, pid, low, high)``: the sampler's volume
    and pan."""
    return [(NOTE_TARGET, "SVOL", 0.25, 0.75), (NOTE_TARGET, "SPAN", -0.8, 0.8)]


def build_program(spec: dict, block_frames: int, device):
    """A one-instance ``RenderProgram`` of the sampler and its node by
    key."""
    from phonic_tpu_torch import (AhdsrConfig, AudioFileBuffer, EngineConfig,
                                  GeneratorPlaybackOptions, Mixer,
                                  RenderProgram, Sampler)
    e = spec["envelope"]
    buf = AudioFileBuffer.from_array(sample_table(spec),
                                     spec["sample"]["sample_rate"])
    sampler = Sampler(buf, GeneratorPlaybackOptions(voices=spec["voices"],
                                                    volume=spec["volume"]),
                      envelope=AhdsrConfig(e["attack"], e["hold"], e["decay"],
                                           e["sustain"], e["release"]),
                      name=NOTE_TARGET)
    main = Mixer("main")
    main.add_source(sampler)
    cfg = EngineConfig(sample_rate=spec["sample_rate"],
                       block_frames=block_frames, device=device)
    return RenderProgram(main, cfg, device=device), {NOTE_TARGET: sampler}


def reference(spec: dict, lanes: int, block_frames: int, device, dtype,
              player: bool = False):
    """The plain reference render (``reference/sampler.py``)."""
    e = spec["envelope"]
    return SamplerReference(
        sample_table(spec), spec["sample"]["sample_rate"],
        spec["sample_rate"], lanes, block_frames, spec["voices"],
        (e["attack"], e["hold"], e["decay"], e["sustain"], e["release"]),
        device, dtype, volume=spec["volume"])


def kernel_ops(spec: dict, lanes: int, block_frames: int) -> dict:
    """Each kernel's operations in one block, from the sampler's shapes:
    ``ramp_read`` reads every voice of every lane at each output frame from
    the one tone, which it reads whole at most."""
    frames = int(round(spec["sample"]["seconds"]
                       * spec["sample"]["sample_rate"]))
    return {"ramp_read": [{"rows": lanes * spec["voices"], "n": block_frames,
                           "channels": spec["sample"]["channels"],
                           "table_frames": frames + 1}]}
