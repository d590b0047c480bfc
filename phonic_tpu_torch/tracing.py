"""Spans and counters of the port's host work, on the profiler's clock.

The port's one tracing system.  A span times one stage of a block's host
work (``engine.step``, ``effect.ChorusEffect``, ``player.wait``, ...): its
name, its start and end in unix nanoseconds, the span it ran inside, and
the block it serves (a block index; a span given none takes its parent's),
so the spans of the Player's pipelined blocks can be told apart.  A counter
counts events where they happen (``kernel.<name>``: launches of a
hand-written kernel).

Tracing is on while a ``torch.profiler`` session records, or between
:func:`enable` and :func:`disable`.  While it is off, :func:`span` reads
two flags and returns one shared no-op context (no clock read, no
allocation) and :func:`count` returns after the same two reads.  While it
is on, the spans are kept in memory (at most ``MAX_SPANS``; later ones are
dropped and counted under ``tracing.dropped``), read with :func:`spans` and
:func:`counters` and cleared with :func:`reset`.  While a profiler records,
each span is also a ``phonic.<name>`` range on the profiler's CPU timeline,
so ``export_chrome_trace`` shows the stages beside the kernels they
launched.  The range is a plain record function, not a user annotation,
so the profiler mirrors nothing of it onto the device's timeline.

The clock is the one the profiler stamps its events with, unix
nanoseconds, read as ``perf_counter_ns()`` plus an offset taken once when
the module is imported: monotonic, so a duration never runs backwards.
"""

from __future__ import annotations

import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 1 << 20


class Span(NamedTuple):
    name: str
    start: int  # unix ns
    end: Optional[int]  # unix ns; None while the span is open
    parent: int  # index in spans() of the span it ran inside, or -1
    block: Optional[int]  # the block it serves


def _unix_offset() -> int:
    """``time_ns() - perf_counter_ns()``, from the pair of reads with the
    shortest gap of a few."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) // 2)
    return best[1]


_OFFSET = _unix_offset()


def now() -> int:
    """The tracing clock: unix nanoseconds, monotonic."""
    return time.perf_counter_ns() + _OFFSET


_enabled = False
_lock = threading.Lock()
_records: list = []  # [name, start, end, parent, block] per span
_counts: dict = {}
_gen = 0  # bumped by reset(): spans opened before it record nothing more
_local = threading.local()  # each thread's open spans: (gen, [indices])


def enable():
    """Trace from now on, whether a profiler records or not."""
    global _enabled
    _enabled = True


def disable():
    """Trace only while a profiler records."""
    global _enabled
    _enabled = False


def reset():
    """Forget every span and counter recorded so far."""
    global _gen
    with _lock:
        _records.clear()
        _counts.clear()
        _gen += 1


def spans() -> list:
    """The spans recorded since the last :func:`reset`, in the order they
    opened (a parent before its children)."""
    with _lock:
        return [Span(*r) for r in _records]


def counters() -> dict:
    """The counters since the last :func:`reset`, by name."""
    with _lock:
        return dict(_counts)


def count(name: str, k: int = 1):
    """Add ``k`` to counter ``name`` while tracing is on."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return
    with _lock:
        _counts[name] = _counts.get(name, 0) + k


def _open_stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None or st[0] != _gen:
        st = _local.stack = (_gen, [])
    return st[1]


class _Span:
    """An open span: :meth:`begin` and :meth:`finish` each read the clock
    once and return what they read.  Under a profiler both reads fall
    inside the span's range, so the range's own setup (the first range of
    a session takes tens of microseconds to open) is in neither's gap."""

    __slots__ = ("name", "block", "index", "gen", "rf")

    def __init__(self, name: str, block: Optional[int]):
        self.name = name
        self.block = block

    def begin(self) -> int:
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch._C._profiler._RecordFunctionFast(
                "phonic." + self.name)
            self.rf.__enter__()
        stack = _open_stack()
        with _lock:
            self.gen = _gen
            parent = stack[-1] if stack else -1
            block = self.block
            if block is None and parent >= 0:
                block = _records[parent][4]
            t0 = now()
            if len(_records) < MAX_SPANS:
                self.index = len(_records)
                _records.append([self.name, t0, None, parent, block])
            else:
                self.index = -1
                _counts["tracing.dropped"] = \
                    _counts.get("tracing.dropped", 0) + 1
        stack.append(self.index)
        return t0

    def finish(self) -> int:
        t1 = now()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        with _lock:
            if self.gen == _gen:
                _open_stack().pop()
                if self.index >= 0:
                    _records[self.index][2] = t1
        return t1

    def __enter__(self):
        self.begin()
        return self

    def __exit__(self, *exc):
        self.finish()
        return False


class _Off:
    """The span of tracing that is off: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, block: Optional[int] = None):
    """A context that records span ``name`` serving ``block`` (default: its
    parent's) while tracing is on; the shared no-op :data:`_OFF` while it is
    off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, block)


class timed:
    """A span for callers that need its duration whether tracing is on or
    not (``Player.cpu_load``): the same two clock reads give the duration
    (``start``, ``end``, ``ns``) and, while tracing is on, the span."""

    __slots__ = ("name", "block", "start", "end", "_span")

    def __init__(self, name: str, block: Optional[int] = None):
        self.name = name
        self.block = block

    def __enter__(self):
        if _enabled or _profiler._is_profiler_enabled:
            self._span = _Span(self.name, self.block)
            self.start = self._span.begin()
        else:
            self._span = None
            self.start = now()
        return self

    def __exit__(self, *exc):
        self.end = now() if self._span is None else self._span.finish()
        return False

    @property
    def ns(self) -> int:
        return self.end - self.start
