"""The port's profiling hooks (``fiber_tpu_torch.utils.profiling``) on
the CPU, held as the JAX package's tests hold its own."""

import json
import os

import torch

from fiber_tpu_torch.utils import profiling
from fiber_tpu_torch.utils.profiling import Timer, annotate, timed, trace


def test_timer_sections_count_and_sum():
    """As ``tests/test_misc.py::test_profiling_timer`` holds the JAX
    package's timer, plus ``add``, the mean and ``reset``."""
    timer = Timer()
    with timer.section("work"):
        pass
    with timer.section("work"):
        pass
    timer.add("io", 0.5)
    timer.add("io", 1.5)
    stats = timer.stats()
    assert stats["work"][0] == 2 and stats["work"][1] >= 0
    assert stats["io"] == (2, 2.0, 1.0)
    timer.reset()
    assert timer.stats() == {}


def test_a_raising_section_is_still_timed():
    timer = Timer()
    try:
        with timer.section("fails"):
            raise KeyError("x")
    except KeyError:
        pass
    assert timer.stats()["fails"][0] == 1


def test_timed_reports_to_the_given_or_the_global_timer():
    mine = Timer()
    with timed("step", mine):
        pass
    assert mine.stats()["step"][0] == 1
    profiling.global_timer.reset()
    with timed("global-step"):
        pass
    assert profiling.global_timer.stats()["global-step"][0] == 1
    assert "global-step" not in mine.stats()
    profiling.global_timer.reset()


def test_trace_writes_a_chrome_trace_holding_the_annotation(tmp_path):
    """The JAX package's ``test_jax_profiler_trace_smoke`` with the
    region's name read back from the trace file."""
    out = str(tmp_path / "trace")
    with trace(out):
        with annotate("test-region"):
            torch.arange(16.0).sum()
    path = os.path.join(out, profiling.TRACE_FILE)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "test-region" in names
    assert any(n and "aten::sum" in n for n in names)
