"""Step timing and profiler traces, counterpart of the JAX package's
``utils/profiling.py`` (the reference only prints wall-clock deltas,
``kitti/train_classifier.py:62,72,131``).

:class:`StepTimer` synchronises the card before it reads the clock, so a
step's time includes its kernels, not only their launches; :func:`trace`
records a ``torch.profiler`` trace of its block into ``log_dir`` (a
Chrome/Perfetto JSON file); :func:`annotate` names a region in it.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict

import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class StepTimer:
    """Wall-clock timer of named blocks, synchronising the card at both
    ends.  ``result`` is accepted for the JAX package's signature; the
    synchronisation covers it."""

    def __init__(self):
        self.history: Dict[str, list] = {}

    @contextlib.contextmanager
    def time(self, name: str, result=None):  # noqa: ARG002
        _sync()
        t0 = time.perf_counter()
        yield
        _sync()
        self.history.setdefault(name, []).append(time.perf_counter() - t0)

    def mean(self, name: str, skip_first: int = 1) -> float:
        h = self.history.get(name, [])
        h = h[skip_first:] if len(h) > skip_first else h
        return sum(h) / max(len(h), 1)


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


@contextlib.contextmanager
def annotate(name: str):
    """A named region in profiler traces."""
    with torch.profiler.record_function(name):
        yield
