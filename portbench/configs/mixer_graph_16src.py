"""mixer_graph_16src: 16 looping file sources on 4 sub-mixers (EQ5 ->
chorus each), a master bus with reverb -> gain, 48 kHz stereo.

The numbers live in ``mixer_graph_16src.json``; this module draws the
graph from the seed, builds it through the program's public API (``Mixer``,
``FileSource``, the effects, ``Player``), names its automation targets, and
gives its plain reference (``reference/mixer_graph.py``) and the shapes of
the kernels' operations per block.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from reference.mixer_graph import MixerGraphReference, tone

CONFIG = json.loads(Path(__file__).with_suffix(".json").read_text())
SPEED_BUCKET_MAX = 6


def spec(seed: int) -> dict:
    """The graph drawn from ``seed``: every source's length, tone, volume,
    pan and speed, every sub-mixer's EQ gains and chorus rate."""
    c = CONFIG
    rng = np.random.default_rng([seed & (2 ** 64 - 1), 0x3167])
    subs = c["submixers"]
    n_src = subs * c["sources_per_submixer"]
    sources = []
    for i in range(n_src):
        sources.append({
            "frames": c["source_frames_base"] + c["source_frames_step"] * i,
            "freq": float(rng.uniform(*c["source_freq_hz"])),
            "volume": float(rng.uniform(*c["source_volume"])),
            "pan": float(rng.uniform(*c["source_pan"])),
            "speed": float(rng.uniform(*c["source_speed"])),
            "submixer": i % subs})
    submixers = [{"eq_gains": [float(g) for g in
                               rng.uniform(*c["eq5_gain_db"], 5)],
                  "chorus_rate": float(rng.uniform(*c["chorus_rate_hz"]))}
                 for _ in range(subs)]
    keys = {f"src{i}": ("source", i) for i in range(n_src)}
    for m in range(subs):
        keys[f"sub{m}/eq"] = ("submixer", m)
        keys[f"sub{m}/chorus"] = ("submixer", m)
    for k in ("reverb", "gain", "master"):
        keys[k] = ("master", 0)
    return {"sample_rate": c["sample_rate"], "sources": sources,
            "submixers": submixers, "chorus": dict(c["chorus"]),
            "reverb": dict(c["reverb"]), "gain": c["gain"],
            "master_gain": None, "keys": keys}


def knobs(spec: dict, mix: dict) -> list:
    """Automation targets ``(key, pid, low, high)`` of the mix's kind:
    ``lanes`` and ``player`` automate the master gain, a source's volume or
    pan, an EQ5 band and the chorus depth (``player`` also the reverb's
    wet)."""
    out = [("gain", "GAIN", 0.5, 1.0)]
    for i in range(len(spec["sources"])):
        out += [(f"src{i}", "VOLU", 0.1, 0.7), (f"src{i}", "PANN", -0.9, 0.9)]
    for m in range(len(spec["submixers"])):
        out += [(f"sub{m}/eq", f"gan{b}", -9.0, 9.0) for b in range(1, 6)]
        out.append((f"sub{m}/chorus", "dpth", 0.05, 0.9))
    if mix["entry"] == "player":
        out.append(("reverb", "wet ", 0.1, 0.35))
    return out


def speed_top(speed: float) -> float:
    """The top of a speed's step bucket (a power of two, at least 1): a
    glide that stays under it keeps the source's read bound."""
    b = math.ceil(math.log2(max(speed, 1e-6)) - 1e-9)
    return float(2 ** min(max(b, 0), SPEED_BUCKET_MAX))


def glide_targets(spec: dict) -> list:
    """``(key, initial speed, bucket top)`` of every source a glide may
    move."""
    return [(f"src{i}", s["speed"], speed_top(s["speed"]))
            for i, s in enumerate(spec["sources"])]


def seek_targets(spec: dict) -> list:
    """``(key, source frames)`` of every source a seek may move."""
    return [(f"src{i}", s["frames"]) for i, s in enumerate(spec["sources"])]


def _nodes(spec: dict):
    """The graph's sources (buffer, options, name, sub-mixer) and each
    sub-mixer's and the master's effects, through the public API."""
    from phonic_tpu_torch import AudioFileBuffer, FilePlaybackOptions
    from phonic_tpu_torch.effects.chorus import ChorusEffect
    from phonic_tpu_torch.effects.eq5 import Eq5Effect
    from phonic_tpu_torch.effects.gain import GainEffect
    from phonic_tpu_torch.effects.reverb import ReverbEffect
    sr = spec["sample_rate"]
    sources = [(AudioFileBuffer.from_array(
        tone(s["frames"], s["freq"], sr)[None], sr),
        FilePlaybackOptions(volume=s["volume"], panning=s["pan"],
                            speed=s["speed"], repeat=None),
        f"src{i}", s["submixer"]) for i, s in enumerate(spec["sources"])]
    ch = spec["chorus"]
    sub_fx = [[Eq5Effect(gains=d["eq_gains"], name="eq"), ChorusEffect(
        rate=d["chorus_rate"], phase=ch["phase"], depth=ch["depth"],
        feedback=ch["feedback"], delay_ms=ch["delay_ms"], wet=ch["wet"],
        filter_freq=ch["filter_freq"], filter_resonance=ch["filter_res"],
        name="chorus")] for d in spec["submixers"]]
    rv = spec["reverb"]
    master_fx = [ReverbEffect(room_size=rv["room_size"], wet=rv["wet"],
                              seed=rv["seed"],
                              min_room_size=rv["min_room_size"],
                              name="reverb"),
                 GainEffect(gain=spec["gain"], name="gain")]
    return sources, sub_fx, master_fx


def build_program(spec: dict, block_frames: int, device):
    """A one-instance ``RenderProgram`` of the graph and its nodes by key."""
    from phonic_tpu_torch import EngineConfig, FileSource, Mixer, RenderProgram
    sources, sub_fx, master_fx = _nodes(spec)
    main = Mixer("main")
    subs = [main.add_mixer(Mixer(f"sub{m}")) for m in range(len(sub_fx))]
    nodes = {}
    for buf, opts, name, m in sources:
        nodes[name] = subs[m].add_source(FileSource(buf, opts, name=name))
    for m, fx in enumerate(sub_fx):
        for e in fx:
            nodes[f"sub{m}/{e.name}"] = subs[m].add_effect(e)
    for e in master_fx:
        nodes[e.name] = main.add_effect(e)
    cfg = EngineConfig(sample_rate=spec["sample_rate"],
                       block_frames=block_frames, device=device)
    return RenderProgram(main, cfg, device=device), nodes


def build_player(spec: dict, output, block_frames: int, device,
                 pipeline_depth: int):
    """A ``Player`` playing the graph with its defaults (metering, CPU
    load, auto-bypass) and its handles by key; the Player's own master
    gain stays at 1 after the graph's reverb and gain."""
    from phonic_tpu_torch import Player, PlayerConfig
    player = Player(output, PlayerConfig(block_frames=block_frames,
                                         pipeline_depth=pipeline_depth),
                    device=device)
    sources, sub_fx, master_fx = _nodes(spec)
    mixers = [player.add_mixer() for _ in sub_fx]
    handles = {}
    for buf, opts, name, m in sources:
        handles[name] = player.play_file(buf, opts, mixer=mixers[m].mixer)
    for m, fx in enumerate(sub_fx):
        for e in fx:
            handles[f"sub{m}/{e.name}"] = mixers[m].add_effect(e)
    for e in master_fx:
        handles[e.name] = player.add_effect(e)
    return player, handles


def reference(spec: dict, lanes: int, block_frames: int, device, dtype,
              player: bool = False):
    """The plain reference render (``reference/mixer_graph.py``), 131072
    frames per step; a Player's graph ends in the Player's master gain of
    1."""
    if player:
        spec = dict(spec, master_gain=1.0)
    return MixerGraphReference(spec, lanes, block_frames, device, dtype,
                               chunk_blocks=max(1, 131072 // block_frames))


def kernel_ops(spec: dict, lanes: int, block_frames: int) -> dict:
    """Each kernel's operations in one block, from the graph's shapes:
    ``ramp_read`` reads every source's table span once for all lanes,
    ``iir2`` runs the five EQ5 bands and the chorus SVF over the sub-mixers'
    rows and the reverb's three lowpasses over the master's."""
    n = block_frames
    span = 0
    for s in spec["sources"]:
        per_row = math.ceil(s["speed"] * n) + 3
        span += min(s["frames"] + 1, lanes * per_row)
    rows = lanes * len(spec["sources"])
    subs = lanes * len(spec["submixers"])
    return {
        "ramp_read": [{"rows": rows, "n": n, "channels": 1,
                       "table_frames": span}],
        "iir2": ([{"rows": 2 * subs, "coef_rows": subs, "n": n}] * 6
                 + [{"rows": 2 * lanes, "coef_rows": lanes, "n": n}] * 3),
    }
