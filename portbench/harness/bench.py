"""One run of one cell: set-up, warm-up, the measured window, the traced
window (``--trace 1``), the correctness check, and the result line.

Everything that belongs to one configuration, traffic mix, metric or
kernel is a file of its own that this module finds by the names in
``BENCHMARK.json``: ``configs/<config>.py`` (and its ``.json``),
``traffic/<mix>.json``, ``metrics/<metric>.py``, ``rooflines/<kernel>.py``
and ``limits/<workload>.json``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import types
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parents[1]
REPO = PKG.parent
for p in (str(PKG), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness.check import compare  # noqa: E402
from harness.entries import ENTRIES, synchronize  # noqa: E402
from harness.trace import WINDOW_SPAN, Trace  # noqa: E402
from harness.traffic import Traffic  # noqa: E402


def benchmark() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, loaded by path (names may hold
    dots)."""
    path = PKG / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def data(kind: str, name: str) -> dict:
    return json.loads((PKG / kind / f"{name}.json").read_text())


def cell_metrics(bench: dict, workload: str, trace: bool) -> list:
    """The metric entries this cell reports in a run with or without the
    trace."""
    def here(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in bench["end_to_end"] if here(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def run(workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, device: str = "cuda", overrides: dict = None):
    """Run the cell once.  Returns (result line dict, check lines).
    ``device`` and ``overrides`` (of the mix's numbers, and the
    configuration's ``CPU_REHEARSAL`` sizes) serve rehearsals and tests on
    the CPU only; ``run.py`` gives neither."""
    bench = benchmark()
    wl = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cfg = module("configs", wl["config"])
    mix = dict(data("traffic", wl["traffic"]), **(overrides or {}))
    if overrides:
        cfg.CONFIG.update(getattr(cfg, "CPU_REHEARSAL", {}))
    limits = data("limits", workload)
    lanes = mix.get("lanes", 1)
    spec = cfg.spec(seed)
    traffic = Traffic(mix, cfg, spec, seed, lanes)
    entry = ENTRIES[mix["entry"]](cfg, spec, mix, traffic, device)
    while entry.block < mix["warm_blocks"]:
        entry.step(mix["warm_blocks"] - entry.block)
    synchronize(device)
    setup_s = time.perf_counter() - t_start

    tr = None
    t0 = time.perf_counter()
    first = entry.block
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        k = mix["trace_blocks"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # a lead-in step outside the window range: device activities
            # the profiler misses as it starts fall there, and the window
            # holds its blocks' work whole
            entry.step(mix["warm_blocks"])
            synchronize(device)
            with record_function(WINDOW_SPAN):
                done = 0
                while done < k:
                    done += entry.step(k - done)
                synchronize(device)
    while time.perf_counter() - t0 < seconds:
        entry.step()
    synchronize(device)
    t1 = entry.arrivals[-1]
    window_blocks = entry.block - first
    mem = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    if trace:
        tr = Trace(prof, mix["trace_blocks"])
        del prof

    r = types.SimpleNamespace(
        cfg=cfg, spec=spec, mix=mix, lanes=lanes, trace=tr, setup_s=setup_s,
        t0=t0, t1=t1, window_blocks=window_blocks, first=first,
        arrivals=entry.arrivals, lower_s=entry.lower_s,
        lowered_blocks=entry.block,
        sample_rate=spec["sample_rate"], device_kind=(
            torch.cuda.get_device_name(0) if device == "cuda" else "cpu"),
        kernel_ops=cfg.kernel_ops(spec, lanes, mix["block_frames"]),
        module=module, data=data, notes=[])
    metrics, lines = {}, []
    if tr is not None:
        lines.append(f"trace: {tr.blocks} blocks in {tr.window_s:.4f} s, "
                     f"{tr.device_ops} device operations, "
                     f"{tr.launch_calls} launch calls")
    for m in cell_metrics(bench, workload, trace):
        value = module("metrics", m["name"]).read(r)
        if value is None:
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if m["name"] == "block_ms.p95":
            lines.append(f"block_ms.p95 over {len(entry.arrivals) - first}"
                         " delivery intervals")

    lines += r.notes
    audio, log, kind = entry.audio, entry.log, r.device_kind
    del entry, r  # the program and its device state go before the check
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    err, per = compare(cfg, spec, mix, log, audio, device)
    limit = limits["err_db"]
    failed = sum(1 for row in per for e in row if not e <= limit)
    attempted = sum(len(row) for row in per)
    lines.append(f"compared {len(per)} blocks x {lanes} lanes against the "
                 f"reference in {time.perf_counter() - t_check:.1f} s")
    worst = sorted(((e, b, lane) for b, row in enumerate(per)
                    for lane, e in enumerate(row)), reverse=True)[:3]
    lines.append("worst answers (err_db, block, lane): " + ", ".join(
        f"({e:.1f}, {b}, {lane})" for e, b, lane in worst))
    lines.append(f"check err_db {err:.4f} limit {limit}")
    result = {
        "correct": bool(failed == 0 and attempted > 0),
        "attempted": attempted, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if device == "cuda" else device,
                   "kind": kind,
                   "count": 1, "memory_peak_bytes": int(mem)}}
    if tr is not None:
        result["device"]["busy_s"] = tr.busy_s
        result["device"]["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["check"] = {"err_db": {"value": err, "limit": limit}}
    return result, lines
