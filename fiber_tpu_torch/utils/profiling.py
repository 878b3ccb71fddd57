"""Tracing and timing hooks.

Counterpart of ``fiber_tpu/utils/profiling.py``:

* :func:`trace` records the enclosed region with ``torch.profiler``
  (host activity, and the card's kernels and copies when CUDA is
  available) and writes a Chrome trace (``trace.json``, which Perfetto
  and ``chrome://tracing`` open) into a directory;
* :func:`annotate` labels a region inside a trace
  (``torch.profiler.record_function``);
* :class:`Timer` and :func:`timed` aggregate host wall-clock time by
  section; :data:`global_timer` is the process-wide timer.

The JAX package also mirrors a trace's location, its annotations and the
global timer's sections into its telemetry registry; the port has no
telemetry plane, so it has no such mirrors.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

#: the file :func:`trace` writes into its directory
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Records the enclosed region and writes its Chrome trace to
    ``log_dir/trace.json`` (the directory is made). Work queued on the
    card inside the block is waited for before the trace stops, so that
    its kernels are in it."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Labels the enclosed region inside an active trace."""
    with record_function(name):
        yield


class Timer:
    """Aggregating wall-clock timer: ``with timer.section("pickle"):
    ...``; ``timer.stats()`` returns {section: (count, total_s,
    mean_s)}."""

    def __init__(self) -> None:
        self._totals: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._totals[name] += seconds
            self._counts[name] += 1

    def stats(self) -> Dict[str, tuple]:
        with self._lock:
            return {
                name: (
                    self._counts[name],
                    round(total, 6),
                    round(total / self._counts[name], 6),
                )
                for name, total in self._totals.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._totals.clear()
            self._counts.clear()


#: the process-wide timer
global_timer = Timer()


@contextlib.contextmanager
def timed(name: str, timer: Optional[Timer] = None) -> Iterator[None]:
    """Times the enclosed region into ``timer`` (the global timer when
    none is given) under ``name``."""
    with (timer or global_timer).section(name):
        yield
