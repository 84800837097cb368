"""Spans and profiler traces, counterpart of the JAX package's
``utils/profiling.py`` (the reference only prints wall-clock deltas,
``kitti/train_classifier.py:62,72,131``).

:func:`span` names a region of the program.  It does nothing unless a
``torch.profiler`` session records, so the spans cost one check each
otherwise.  While one records, a span opens a ``record_function`` range
(on the profiler's clock, beside the device operations of the trace),
records a pair of CUDA events on the current stream where the card is in
use, and keeps a record in memory: its name, the enclosing span, the
top-level span's id, its host time and the events.  :func:`span_table`
reads the records per span name, :func:`reset` drops them.
:func:`trace` records a ``torch.profiler`` trace of its block into
``log_dir`` (a Chrome/Perfetto JSON file).
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import os
import threading
import time
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

import torch

_profiling = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@dataclasses.dataclass
class SpanRecord:
    """One span: ``parent`` is the enclosing span's record, ``top`` the
    top-level span's (name, ids); ``host_ns`` is None while
    the span is open, ``events`` None once :func:`span_table` has read
    them into ``device_ms`` (or where no card is in use)."""
    name: str
    parent: Optional["SpanRecord"]
    top: tuple
    events: Optional[tuple] = None
    host_ns: Optional[int] = None
    device_ms: Optional[float] = None


class SpanStats(NamedTuple):
    """One span name's records: the calls, the distinct top-level ids
    they ran under (steps, batches), and host, device and self device
    time in ms (the device times None without a card; self time is the
    span's less its child spans')."""
    calls: int
    tops: int
    host_ms: float
    device_ms: Optional[float]
    self_device_ms: Optional[float]


class SpanLog:
    """The records of the spans opened while a profiler recorded."""

    def __init__(self):
        self.records: List[SpanRecord] = []
        self._local = threading.local()
        self.serial = itertools.count()

    def stack(self) -> List[SpanRecord]:
        """This thread's open spans, innermost last."""
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def table(self) -> Dict[str, SpanStats]:
        closed = [r for r in self.records if r.host_ns is not None]
        if any(r.events is not None for r in closed):
            torch.cuda.synchronize()
        for r in closed:
            if r.events is not None:
                r.device_ms = r.events[0].elapsed_time(r.events[1])
                r.events = None
        child_ms: Dict[int, float] = defaultdict(float)
        by_name: Dict[str, List[SpanRecord]] = defaultdict(list)
        for r in closed:
            if r.parent is not None and r.device_ms is not None:
                child_ms[id(r.parent)] += r.device_ms
            by_name[r.name].append(r)
        out = {}
        for name, recs in by_name.items():
            timed = all(r.device_ms is not None for r in recs)
            dev = sum(r.device_ms for r in recs) if timed else None
            out[name] = SpanStats(
                calls=len(recs), tops=len({r.top for r in recs}),
                host_ms=sum(r.host_ns for r in recs) / 1e6,
                device_ms=dev,
                self_device_ms=(dev - sum(child_ms[id(r)] for r in recs)
                                if timed else None))
        return out


_LOG = SpanLog()


class _Span:
    __slots__ = ("name", "ids", "range", "rec", "t0")

    def __init__(self, name: str, ids: dict):
        self.name, self.ids = name, ids

    def __enter__(self):
        stack = _LOG.stack()
        if stack:
            parent = stack[-1]
            top = parent.top
        else:
            parent = None
            top = (self.name, tuple(sorted(self.ids.items())) if self.ids
                   else next(_LOG.serial))
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        rec = SpanRecord(self.name, parent, top)
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            rec.events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        _LOG.records.append(rec)
        stack.append(rec)
        self.rec = rec
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        rec.host_ns = time.perf_counter_ns() - self.t0
        if rec.events is not None:
            rec.events[1].record()
        _LOG.stack().pop()
        self.range.__exit__(*exc)
        return False


def span(name: str, **ids):
    """A named region of the program (module docstring): a no-op unless
    a ``torch.profiler`` session records.  ``ids`` name a top-level
    span's occurrence (``step=state.step``); an enclosed span is counted
    under its top-level span's, and a top-level span without ids gets a
    serial number (a count of the profiled calls)."""
    if not _profiling():
        return _OFF
    return _Span(name, ids)


def span_table() -> Dict[str, SpanStats]:
    """Per span name, the records kept since the last :func:`reset`
    (:class:`SpanStats`); reads the CUDA events with one sync."""
    return _LOG.table()


def reset() -> None:
    """Drop the records kept so far."""
    _LOG.records.clear()


def is_span_range(evt) -> bool:
    """Whether a row of a profiler's ``key_averages()`` is a span's range
    rather than an operation: the trace lays each range on the device's
    timeline too, with the device time of the operations inside it, so a
    sum of device time over the rows counts them twice."""
    return bool(getattr(evt, "is_user_annotation", False)) or \
        evt.key in {r.name for r in _LOG.records}


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and the card where one is in use) and
    write ``trace_<pid>_<ns>.json`` into ``log_dir``; the path is the
    profiler's ``trace_path`` attribute afterwards."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        _sync()
        prof.__exit__(None, None, None)
        prof.trace_path = os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(prof.trace_path)
