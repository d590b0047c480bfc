"""Reduction of a ``torch.profiler`` window to what the per-layer metrics
read: the device's operations and the union of their intervals, copies,
stream synchronisations, kernel-only time by name, and a breakdown of the
device time and of the idle gaps by what the host was doing."""

from __future__ import annotations

import bisect
import collections

WINDOW_SPAN = "bench.window"
BENCH_PREFIX = "bench."
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                "cudaMemsetAsync")


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Trace:
    """One traced window of ``blocks`` whole blocks (the profiler's events
    inside the ``bench.window`` range)."""

    def __init__(self, prof, blocks: int):
        from torch.autograd import DeviceType
        events = list(prof.events())
        spans = [e for e in events if e.name == WINDOW_SPAN
                 and e.device_type == DeviceType.CPU]
        if not spans:
            raise RuntimeError("the trace has no bench.window range")
        w0, w1 = spans[0].time_range.start, spans[0].time_range.end
        self.blocks = blocks
        self.window_s = (w1 - w0) / 1e6
        # the device's own activities: the benchmark's ranges show on the
        # device's timeline too, and are no work of it
        dev = [e for e in events if e.device_type == DeviceType.CUDA
               and not e.name.startswith(BENCH_PREFIX)
               and e.time_range.end > w0 and e.time_range.start < w1]
        cpu = [e for e in events if e.device_type == DeviceType.CPU
               and e.time_range.end > w0 and e.time_range.start < w1]
        self.device_ops = len(dev)
        merged = _union((max(e.time_range.start, w0),
                         min(e.time_range.end, w1)) for e in dev)
        self.busy_s = sum(e - s for s, e in merged) / 1e6
        self.h2d = sum("HtoD" in e.name for e in dev)
        self.syncs = sum(e.name == "cudaStreamSynchronize" for e in cpu)
        # the host's calls that put work on the device: as many as device
        # operations where the profiler dropped none
        self.launch_calls = sum(e.name.startswith(LAUNCH_CALLS) for e in cpu)
        self._dev = dev
        by_name = collections.Counter()
        for e in dev:
            by_name[e.name] += e.time_range.elapsed_us() / 1e6
        self.device_time = by_name
        self.gaps = self._gaps(merged, w0, w1, cpu)

    def kernel(self, needle: str):
        """(launches, kernel-only seconds) of the device operations whose
        name holds ``needle``."""
        hits = [e for e in self._dev if needle in e.name]
        return len(hits), sum(e.time_range.elapsed_us() for e in hits) / 1e6

    @staticmethod
    def _gaps(merged, w0, w1, cpu):
        """Idle device time by what the host was doing: each gap goes to
        the innermost benchmark range and the innermost host operation
        covering its middle."""
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        bench = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in cpu if e.name.startswith(BENCH_PREFIX)
                       and e.name != WINDOW_SPAN)
        ops = sorted((e.time_range.start, e.time_range.end, e.name)
                     for e in cpu if not e.name.startswith(BENCH_PREFIX))
        b_starts = [s for s, _, _ in bench]
        o_starts = [s for s, _, _ in ops]

        def inner(items, starts, t):
            i = bisect.bisect_right(starts, t) - 1
            for j in range(i, max(i - 64, -1), -1):
                if items[j][1] >= t:
                    return items[j][2]
            return None

        out = collections.Counter()
        for s, e in gaps:
            mid = 0.5 * (s + e)
            where = inner(bench, b_starts, mid) or "outside"
            op = inner(ops, o_starts, mid) or "python"
            out[f"{where}/{op}"] += (e - s) / 1e6
        return out

    def breakdown(self, top: int = 10) -> dict:
        return {"device_ops": [[k[:120], v] for k, v in
                               self.device_time.most_common(top)],
                "idle_gaps": [[k[:120], v] for k, v in
                              self.gaps.most_common(top)]}
