"""Spans around the benchmark's calls into the program, and the reading of
a ``torch.profiler`` window.

:class:`Spans` records each named span as a pair of CUDA events (in the
timed window of a ``--trace 1`` run) and as a ``record_function`` range
(inside the profiled window).  :func:`profile` runs the loop under the
profiler, exports the Chrome trace to a temporary file, reads the device
operations and the host's spans from it and deletes it.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "portbench.window"
TOP = 10


class Spans:
    """Named spans; a no-op unless ``events`` or ``profiling`` is on."""

    def __init__(self, events: bool = False):
        self.events = events
        self.profiling = False
        self._pending: List[Tuple[str, object, object]] = []
        self.ms: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = (torch.profiler.record_function(name) if self.profiling
              else contextlib.nullcontext())
        with rf:
            if not self.events:
                yield
                return
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            yield
            b.record()
            self._pending.append((name, a, b))

    def collect(self) -> None:
        """Read the recorded events (after the window's last sync)."""
        if self._pending:
            torch.cuda.synchronize()
        for name, a, b in self._pending:
            self.ms[name].append(a.elapsed_time(b))
        self._pending.clear()


def profile(run, spans: Spans) -> dict:
    """Run ``run()`` under ``torch.profiler`` with the spans recorded as
    ranges.  Returns ``{"device": [(name, start_us, dur_us)], "host":
    [(name, start_us, dur_us)], "window": (start_us, dur_us)}``; the
    device list is empty where the trace holds no device time."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    spans.profiling = True
    try:
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                run()
    finally:
        spans.profiling = False
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    device, host, window = [], [], None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        item = (e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
        if cat in DEVICE_CATEGORIES:
            device.append(item)
        elif cat == "user_annotation":
            if e["name"] == WINDOW:
                window = item[1:]
            else:
                host.append(item)
    return {"device": device, "host": host, "window": window}


def busy_intervals(prof: dict) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals inside the window."""
    w0, wd = prof["window"]
    w1 = w0 + wd
    iv = sorted((max(s, w0), min(s + d, w1)) for _, s, d in prof["device"]
                if s < w1 and s + d > w0)
    out: List[Tuple[float, float]] = []
    for a, b in iv:
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_s(prof: dict) -> float:
    return sum(b - a for a, b in busy_intervals(prof)) / 1e6


def kernel_us(prof: dict, patterns) -> Tuple[float, int]:
    """Device time (us) and count of the operations whose name holds one
    of ``patterns``."""
    hits = [d for n, _, d in prof["device"] if any(p in n for p in patterns)]
    return sum(hits), len(hits)


def breakdown(prof: dict) -> dict:
    """The device operations with most time, and the idle time of the
    device by the innermost span the host was in (``"outside spans"``
    where it was in none), each the top :data:`TOP`, in seconds."""
    ops: Dict[str, float] = defaultdict(float)
    for n, _, d in prof["device"]:
        ops[n] += d / 1e6
    w0, wd = prof["window"]
    edges = [w0] + [x for iv in busy_intervals(prof) for x in iv] + [w0 + wd]
    gaps: Dict[str, float] = defaultdict(float)
    host = sorted(prof["host"], key=lambda h: h[2])        # innermost first
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = next((n for n, s, d in host if s <= mid <= s + d),
                    "outside spans")
        gaps[name] += (b - a) / 1e6

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                [:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
