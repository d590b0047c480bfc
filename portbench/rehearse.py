"""Rehearse the benchmark on the CPU (never a measurement).

    python3 portbench/rehearse.py [--full]

Checks ``BENCHMARK.json`` against the benchmark's rules (names, units,
keys, files, every per-layer metric's cells reporting the end-to-end
metric it moves, at most 24 cells), then builds every cell's graph and
traffic and renders 2 blocks on the CPU with the kernels' plain versions:
the same seed must give the same graph and events, another seed others,
and the render must match the reference.  Without ``--full`` the cells run
at 16384-frame blocks and at most 2 lanes, to keep the CPU's time short.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent
sys.path.insert(0, str(PKG))

from harness import bench as harness  # noqa: E402
from harness.check import compare  # noqa: E402
from harness.entries import ENTRIES  # noqa: E402
from harness.traffic import Traffic  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def validate(b: dict) -> list:
    """Every rule of the file that can be checked without a run; returns
    the faults found."""
    bad = []

    def need(cond, msg):
        if not cond:
            bad.append(msg)

    need(set(b) == {"command", "paths", "run_seconds", "configs",
                    "workloads", "end_to_end", "per_layer"},
         f"top-level keys {sorted(b)}")
    need(1 <= len(b["paths"]) <= 16, "1 to 16 paths")
    for p in b["paths"]:
        need(re.fullmatch(r"[A-Za-z0-9_./\-]{1,200}", p) and ".." not in p
             and not p.startswith("/"), f"path {p!r}")
    need(len(b["command"]) <= 32 and all(
        not w.startswith("/") and ".." not in w for w in b["command"]),
        "command")
    need(isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51,
         "run_seconds")
    cells = len(b["workloads"])
    need(1 <= cells <= 24, "1 to 24 cells")
    budget = (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200
    need(budget <= 43200, f"a full check of 24 cells takes {budget} s")
    names = set()
    for c in b["configs"]:
        need(set(c) == {"name", "source", "file", "reduced", "why"},
             f"config keys {sorted(c)}")
        need(NAME.match(c["name"]), f"config name {c['name']!r}")
        need(any(c["file"].startswith(p + "/") for p in b["paths"])
             and (PKG.parent / c["file"]).is_file(), f"file {c['file']}")
        need(len(c["reduced"]) <= 16 and all(NAME.match(k)
                                            for k in c["reduced"]),
             "reduced")
        need((PKG / "configs" / f"{c['name']}.py").is_file(),
             f"configs/{c['name']}.py")
        need(1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200,
             f"{c['name']}: why / source length")
        names.add(c["name"])
    pairs, used = set(), set()
    four = sum(w["chips"] == 4 for w in b["workloads"])
    need(four <= max(1, cells // 4), "too many 4-chip cells")
    for w in b["workloads"]:
        need(set(w) == {"name", "config", "traffic", "chips", "why"},
             f"workload keys {sorted(w)}")
        need(NAME.match(w["name"]) and NAME.match(w["traffic"]),
             f"workload name {w['name']!r}")
        need(w["config"] in names, f"{w['name']}: unknown config")
        need(w["chips"] in (1, 4), f"{w['name']}: chips")
        need(1 <= len(w["why"]) <= 200 and "\n" not in w["why"],
             f"{w['name']}: why")
        need((w["config"], w["traffic"]) not in pairs, "repeated pair")
        pairs.add((w["config"], w["traffic"]))
        used.add(w["config"])
        for kind, ext in (("traffic", w["traffic"]), ("limits", w["name"])):
            need((PKG / kind / f"{ext}.json").is_file(), f"{kind}/{ext}.json")
    need(used == names, "a configuration no cell uses")
    metric_names = set()
    for m in b["end_to_end"] + b["per_layer"]:
        need(NAME.match(m["name"]) and m["name"] not in metric_names,
             f"metric name {m['name']!r}")
        metric_names.add(m["name"])
        need(UNIT.match(m["unit"]), f"{m['name']}: unit {m['unit']!r}")
        need(m["better"] in ("lower", "higher"), f"{m['name']}: better")
        need(m["source"] in SOURCES, f"{m['name']}: source")
        need((PKG / "metrics" / f"{m['name']}.py").is_file(),
             f"metrics/{m['name']}.py")
    e2e = {m["name"]: m for m in b["end_to_end"]}
    need(1 <= len(e2e) <= 16 and "setup_s" in e2e, "end-to-end metrics")
    for m in b["end_to_end"]:
        need(set(m) <= {"name", "unit", "better", "bound", "source",
                        "workloads"}, f"{m['name']}: keys")
        need(m["source"] in ("host_clock", "device_trace"),
             f"{m['name']}: an end-to-end source")
        need(0 < m["bound"] <= 0.25, f"{m['name']}: bound")

    def reports(cell, metric):
        return cell in metric.get("workloads", [cell])
    need(1 <= len(b["per_layer"]) <= 128, "per-layer metrics")
    for m in b["per_layer"]:
        need(set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                        "workloads"}, f"{m['name']}: keys")
        need(m["moves"] in e2e, f"{m['name']}: moves {m['moves']}")
        need(1 <= len(m["layer"]) <= 200, f"{m['name']}: layer")
        for cell in m.get("workloads", [w["name"] for w in b["workloads"]]):
            need(reports(cell, e2e.get(m["moves"], {})),
                 f"{m['name']}: {cell} does not report {m['moves']}")
    for w in b["workloads"]:
        mine = [m for m in b["end_to_end"] if reports(w["name"], m)]
        need(len(mine) >= 2, f"{w['name']}: setup_s and one more e2e")
        need(any(w["name"] in m.get("workloads", [w["name"]])
                 for m in b["per_layer"]), f"{w['name']}: no per-layer")
    need(len(json.dumps(b)) <= 64 * 1024, "larger than 64 KiB")
    return bad


def rehearse_cell(w: dict, full: bool) -> str:
    cfg = harness.module("configs", w["config"])
    mix = harness.data("traffic", w["traffic"])
    if not full:
        mix = dict(mix, block_frames=min(mix["block_frames"], 16384))
        if "lanes" in mix:
            mix["lanes"] = min(mix["lanes"], 2)
        cfg.CONFIG.update(getattr(cfg, "CPU_REHEARSAL", {}))
    lanes = mix.get("lanes", 1)
    seeds = (2 ** 31 + 77, 2 ** 31 + 77, 12345)
    seen = []
    for seed in seeds:
        spec = cfg.spec(seed)
        tr = Traffic(mix, cfg, spec, seed, lanes)
        seen.append((json.dumps(spec, sort_keys=True),
                     repr([[tr.events(lane, b) for lane in range(lanes)]
                           for b in range(8)])))
    if seen[0] != seen[1]:
        raise AssertionError(f"{w['name']}: one seed, two inputs")
    if seen[0][0] == seen[2][0] or seen[0][1] == seen[2][1]:
        raise AssertionError(f"{w['name']}: two seeds, one graph or one "
                             "set of events")
    spec = cfg.spec(seeds[0])
    entry = ENTRIES[mix["entry"]](cfg, spec, mix, Traffic(
        mix, cfg, spec, seeds[0], lanes), "cpu")
    while entry.block < 2:
        entry.step(2 - entry.block)
    err, _ = compare(cfg, spec, mix, entry.log, entry.audio, "cpu")
    limit = harness.data("limits", w["name"])["err_db"]
    if not err <= limit:
        raise AssertionError(f"{w['name']}: err_db {err} over {limit}")
    return (f"{w['name']}: 2 blocks of {mix['block_frames']} x {lanes} "
            f"lane(s) on the CPU, err_db {err:.1f} (limit {limit})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true",
                    help="the cells' own block sizes and lanes")
    args = ap.parse_args()
    b = harness.benchmark()
    bad = validate(b)
    for msg in bad:
        print("BENCHMARK.json:", msg)
    if bad:
        return 1
    print(f"BENCHMARK.json: {len(b['workloads'])} cells, "
          f"{len(b['end_to_end'])} + {len(b['per_layer'])} metrics: ok")
    for w in b["workloads"]:
        print(rehearse_cell(w, args.full), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
