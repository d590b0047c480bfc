"""synth_64v: one 64-voice subtractive synth generator per lane (upstream's
FunDSP generator playing sub3, with a modulation matrix) under a dense note
part, 48 kHz stereo.

The numbers live in ``synth_64v.json``; this module builds the generator
through the program's public API, names its automation targets, adds the
note entry (``harness/notes.py``) to the harness's entries, and gives its
plain reference (``reference/synth.py``) and the shapes of the kernels'
operations per block.  The patch is upstream's and the same for every seed
(the seed draws the note part and the knob turns, ``spec`` names it).

It needs a port whose synth generator renders every note that starts on a
voice in a block; with one that lowers a single trigger per voice and
block, the import below fails and the run exits at once.
"""

from __future__ import annotations

import json
from pathlib import Path

import phonic_tpu_torch as pt
from harness.entries import ENTRIES
from harness.notes import NotesEntry
from reference.synth import SynthReference

CONFIG = json.loads(Path(__file__).with_suffix(".json").read_text())
CPU_REHEARSAL = {}
NOTE_TARGET = "synth"
ENTRIES.setdefault("lanes_notes", NotesEntry)


def _renders_every_start() -> bool:
    """Whether the port's synth generator lowers a trigger slot for each
    of two notes that start on one voice in one block."""
    gen = pt.SynthGenerator(pt.synths.sub3(),
                            pt.GeneratorPlaybackOptions(voices=1))
    for t in (8, 16):
        gen.note_on(60, time=t)
    main = pt.Mixer("main")
    main.add_source(gen)
    pt.RenderProgram(main, pt.EngineConfig(block_frames=64, device="cpu"),
                     device="cpu")
    return gen.lower_block_inputs(0, 64)["_trig_time"].shape == (1, 2)


if not _renders_every_start():
    raise ImportError("this port's synth generator renders one note start "
                      "per voice and block; synth_64v needs every start")


def spec(seed: int) -> dict:
    """The generator's settings (the same for every seed) and the seed."""
    c = CONFIG
    return {"seed": seed & (2 ** 64 - 1), "sample_rate": c["sample_rate"],
            "voices": c["voices"], "volume": c["volume"],
            "release_secs": c["release_secs"], "patch": dict(c["patch"]),
            "modulation": json.loads(json.dumps(c["modulation"]))}


def knobs(spec: dict, mix: dict) -> list:
    """Automation targets ``(key, pid, low, high)``: the generator's volume
    and pan, and sub3's cutoff and resonance."""
    return [(NOTE_TARGET, "SVOL", 0.25, 0.75), (NOTE_TARGET, "SPAN", -0.8, 0.8),
            (NOTE_TARGET, "CUTF", 300.0, 8000.0),
            (NOTE_TARGET, "RESO", 0.1, 0.8)]


def _modulation(spec: dict):
    sources = []
    for s in spec["modulation"]["sources"]:
        if s["kind"] == "lfo":
            sources.append(pt.LfoSource(s["id"], rate=s["rate"],
                                        waveform=s["waveform"]))
        elif s["kind"] == "envelope":
            sources.append(pt.EnvelopeSource(
                s["id"], attack=s["attack"], hold=s["hold"],
                decay=s["decay"], sustain=s["sustain"],
                release=s["release"]))
        else:
            sources.append(pt.VelocitySource(s["id"]))
    return pt.ModulationConfig(sources=tuple(sources),
                               targets=tuple(spec["modulation"]["targets"]))


def build_program(spec: dict, block_frames: int, device):
    """A one-instance ``RenderProgram`` of the generator and its node by
    key.  sub3 carries its amp AHDSR (the configuration's ``envelope``)."""
    p = spec["patch"]
    gen = pt.SynthGenerator(
        pt.synths.sub3(shape=p["shape"], detune_cents=p["detune_cents"],
                       cutoff=p["cutoff"], resonance=p["resonance"]),
        pt.GeneratorPlaybackOptions(voices=spec["voices"],
                                    volume=spec["volume"]),
        release_secs=spec["release_secs"], name=NOTE_TARGET)
    gen.with_modulation(_modulation(spec))
    for source, target, amount, bipolar in spec["modulation"]["routings"]:
        gen.set_modulation(source, target, amount, bipolar)
    main = pt.Mixer("main")
    main.add_source(gen)
    cfg = pt.EngineConfig(sample_rate=spec["sample_rate"],
                          block_frames=block_frames, device=device)
    return pt.RenderProgram(main, cfg, device=device), {NOTE_TARGET: gen}


def reference(spec: dict, lanes: int, block_frames: int, device, dtype,
              player: bool = False):
    """The plain reference render (``reference/synth.py``)."""
    return SynthReference(lanes, spec["sample_rate"], block_frames,
                          spec["voices"], spec["patch"], spec["modulation"],
                          device, dtype, volume=spec["volume"],
                          release_secs=spec["release_secs"])


def kernel_ops(spec: dict, lanes: int, block_frames: int) -> dict:
    """Each kernel's operations in one block, from the generator's shapes:
    ``iir2`` runs sub3's SVF over every voice of every lane, each voice
    its own coefficients."""
    rows = lanes * spec["voices"]
    return {"iir2": [{"rows": rows, "coef_rows": rows, "n": block_frames}]}
