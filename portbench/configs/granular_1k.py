"""granular_1k: one 10-voice granular sampler per lane (upstream's grain
engine, 100 grains a voice, with the stock modulation matrix) playing a
pad part on a texture, 48 kHz stereo: about a thousand grains a lane.

The numbers live in ``granular_1k.json``; this module draws the texture
from the seed (on the card when there is one), builds the sampler through
the program's public API, names its automation targets, adds the note
entry (``harness/notes.py``) to the harness's entries, and gives its plain
reference (``reference/granular.py``) and the shapes of the kernels'
operations per block.

It needs a port whose granular sampler renders every note that starts on
a voice in a block; with one that lowers a single trigger per voice and
block, the import below fails and the run exits at once.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

import phonic_tpu_torch as pt
from harness.entries import ENTRIES
from harness.notes import NotesEntry
from reference.granular import GranularReference

CONFIG = json.loads(Path(__file__).with_suffix(".json").read_text())
CPU_REHEARSAL = {}
NOTE_TARGET = "sampler"
ENTRIES.setdefault("lanes_notes", NotesEntry)


def _renders_every_start() -> bool:
    """Whether the port's granular sampler lowers a trigger slot for each
    of two notes that start on one voice in one block."""
    buf = pt.AudioFileBuffer.from_array(np.zeros((1, 256), np.float32), 48000)
    s = pt.Sampler(buf, pt.GeneratorPlaybackOptions(voices=1))
    s.with_granular_playback()
    for t in (8, 16):
        s.note_on(60, time=t)
    main = pt.Mixer("main")
    main.add_source(s)
    pt.RenderProgram(main, pt.EngineConfig(block_frames=64, device="cpu"),
                     device="cpu")
    return s.lower_block_inputs(0, 64)["_trig_time"].shape == (1, 2)


if not _renders_every_start():
    raise ImportError("this port's granular sampler renders one note start "
                      "per voice and block; granular_1k needs every start")


def spec(seed: int) -> dict:
    """The sampler's settings (the same for every seed) and its texture's
    partials, drawn from ``seed``."""
    c, s = CONFIG, CONFIG["sample"]
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x6A41])
    k = s["partials"]
    lo, hi = (math.log(f) for f in s["freq_hz"])
    freqs = np.exp(rng.uniform(lo, hi, k))
    amps = (freqs / s["freq_hz"][0]) ** -rng.uniform(*s["partial_rolloff"]) \
        * rng.uniform(0.5, 1.0, k)
    texture = {"freqs": freqs.tolist(), "amps": (amps / amps.sum()).tolist(),
               "am_hz": rng.uniform(*s["am_hz"], k).tolist(),
               "am_depth": rng.uniform(*s["am_depth"], k).tolist(),
               "am_phase": rng.uniform(0, 2 * math.pi, k).tolist(),
               "phases": rng.uniform(0, 2 * math.pi,
                                     (s["channels"], k)).tolist()}
    return {"seed": seed & (2 ** 64 - 1), "sample_rate": c["sample_rate"],
            "voices": c["voices"], "volume": c["volume"],
            "envelope": dict(c["envelope"]), "granular": dict(c["granular"]),
            "lfo_rates": list(c["lfo_rates"]),
            "routings": [list(r) for r in c["routings"]],
            "sample": dict(s), "texture": texture}


_TABLES = {}


def sample_table(spec: dict) -> np.ndarray:
    """The texture's float32 samples [channels, frames], made on the card
    (the CPU without one); the program and the reference read the same
    ones."""
    key = json.dumps([spec["sample"], spec["texture"]])
    if key not in _TABLES:
        _TABLES.clear()
        s, tx = spec["sample"], spec["texture"]
        dev = "cuda" if torch.cuda.is_available() else "cpu"
        t = torch.arange(int(round(s["seconds"] * s["sample_rate"])),
                         dtype=torch.float64, device=dev) / s["sample_rate"]
        chans = []
        for ph in tx["phases"]:
            x = torch.zeros_like(t)
            for f, a, m, d, mp, p in zip(tx["freqs"], tx["amps"], tx["am_hz"],
                                         tx["am_depth"], tx["am_phase"], ph):
                swell = 1.0 - 0.5 * d * (1.0 - torch.cos(
                    2 * math.pi * m * t + mp))
                x += a * swell * torch.sin(2 * math.pi * f * t + p)
            chans.append(x)
        x = torch.stack(chans)
        _TABLES[key] = (s["peak"] * x / x.abs().max()).float().cpu().numpy()
    return _TABLES[key]


def knobs(spec: dict, mix: dict) -> list:
    """Automation targets ``(key, pid, low, high)``: the sampler's volume,
    the grains' position, size and density."""
    return [(NOTE_TARGET, "SVOL", 0.25, 0.75), (NOTE_TARGET, "GPOS", 0.1, 0.9),
            (NOTE_TARGET, "GSIZ", 200.0, 1000.0),
            (NOTE_TARGET, "GDEN", 20.0, 100.0)]


def build_program(spec: dict, block_frames: int, device):
    """A one-instance ``RenderProgram`` of the sampler and its node by
    key."""
    e, g = spec["envelope"], spec["granular"]
    buf = pt.AudioFileBuffer.from_array(sample_table(spec),
                                        spec["sample"]["sample_rate"])
    sampler = pt.Sampler(
        buf, pt.GeneratorPlaybackOptions(voices=spec["voices"],
                                         volume=spec["volume"]),
        envelope=pt.AhdsrConfig(e["attack"], e["hold"], e["decay"],
                                e["sustain"], e["release"]),
        name=NOTE_TARGET).with_granular_playback(pt.GranularConfig(**g))
    for source, target, amount, bipolar in spec["routings"]:
        sampler.set_modulation(source, target, amount, bipolar=bipolar)
    main = pt.Mixer("main")
    main.add_source(sampler)
    cfg = pt.EngineConfig(sample_rate=spec["sample_rate"],
                          block_frames=block_frames, device=device)
    return pt.RenderProgram(main, cfg, device=device), {NOTE_TARGET: sampler}


def reference(spec: dict, lanes: int, block_frames: int, device, dtype,
              player: bool = False):
    """The plain reference render (``reference/granular.py``)."""
    e = spec["envelope"]
    return GranularReference(
        sample_table(spec), spec["sample"]["sample_rate"],
        spec["sample_rate"], lanes, block_frames, spec["voices"],
        (e["attack"], e["hold"], e["decay"], e["sustain"], e["release"]),
        spec["granular"], spec["routings"], device, dtype,
        volume=spec["volume"], lfo_rates=spec["lfo_rates"])


def kernel_ops(spec: dict, lanes: int, block_frames: int) -> dict:
    """Each kernel's operations in one block, from the sampler's shapes:
    ``ramp_read`` reads every grain slot of every voice of every lane at
    each output frame from the mono texture at the output rate, extended
    by a frame at each end, which it reads whole at most."""
    s = spec["sample"]
    frames = int(round(s["seconds"] * s["sample_rate"]))
    mono = max(int(frames / (s["sample_rate"] / spec["sample_rate"])), 1)
    return {"ramp_read": [{"rows": lanes * spec["voices"]
                           * CONFIG["grains_per_voice"], "n": block_frames,
                           "channels": 1, "table_frames": mono + 2}]}
