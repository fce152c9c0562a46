"""Trace spans and programmatic profiler capture (counterpart of
``mia_tpu/utils/profiling.py``).

- ``trace_span(name)``: a ``torch.profiler.record_function(name)`` range,
  visible by name in a profiler trace, that also adds its wall-clock time to
  a process-local registry. A span adds no synchronisation: its wall time is
  the host's (the time to queue the work on the card, plus whatever the host
  waited for inside it); the card's time for the span is read from a trace
  by the span's name (the ``gpu_user_annotation`` range of the same name).
- ``phase_times()`` / ``reset_phase_times()``: the registry, for log lines.
- ``start_profiler(logdir)`` / ``stop_profiler()``: a ``torch.profiler``
  capture of the CPU and, when a card is present, CUDA activity; the trace
  is written into ``logdir`` as a Chrome trace (``*.pt.trace.json``, which
  TensorBoard's profiler plugin reads) when the capture stops.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch

_LOCK = threading.Lock()
_PHASE_TIMES: dict[str, float] = defaultdict(float)
_PHASE_COUNTS: dict[str, int] = defaultdict(int)
_PROFILER: tuple[torch.profiler.profile, Path] | None = None


@contextlib.contextmanager
def trace_span(name: str):
    start = time.perf_counter()
    with torch.profiler.record_function(name):
        yield
    elapsed = time.perf_counter() - start
    with _LOCK:
        _PHASE_TIMES[name] += elapsed
        _PHASE_COUNTS[name] += 1


def phase_times() -> dict[str, dict[str, float]]:
    """``{name: {"total_s", "count", "mean_s"}}`` of every span since the
    last reset."""
    with _LOCK:
        return {
            name: {
                "total_s": _PHASE_TIMES[name],
                "count": _PHASE_COUNTS[name],
                "mean_s": _PHASE_TIMES[name] / max(_PHASE_COUNTS[name], 1),
            }
            for name in _PHASE_TIMES
        }


def reset_phase_times():
    with _LOCK:
        _PHASE_TIMES.clear()
        _PHASE_COUNTS.clear()


def start_profiler(logdir: str | Path):
    """Start a capture whose trace ``stop_profiler`` writes into ``logdir``."""
    global _PROFILER
    if _PROFILER is not None:
        raise RuntimeError("a profiler capture is already running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _PROFILER = (prof, Path(logdir))


def stop_profiler() -> Path:
    """Stop the capture and write its trace; returns the trace's path."""
    global _PROFILER
    if _PROFILER is None:
        raise RuntimeError("no profiler capture is running")
    prof, logdir = _PROFILER
    _PROFILER = None
    prof.stop()
    logdir.mkdir(parents=True, exist_ok=True)
    path = logdir / f"{os.uname().nodename}_{os.getpid()}.{time.time_ns()}.pt.trace.json"
    prof.export_chrome_trace(str(path))
    return path
