"""The port's telemetry exporters (``fiber_tpu_torch/telemetry/export.py``).

``chrome_trace``, ``prometheus_text`` and ``parse_prometheus_text`` are
the JAX package's and render the same spans and snapshots alike. The
merge of a device capture is the port's: it finds the ``trace.json``
that ``utils.profiling.trace`` writes (the JAX finder looks for
``*.trace.json`` and would merge nothing), maps Kineto's pids and tids
of any type to lane numbers (the JAX merge's ``int(pid)`` fails on
Kineto's string pids and drops the whole merge), and names the card's
lanes ``CUDA ...`` and the profiler's host lanes ``torch ...``.
"""

import json
import time
from multiprocessing.connection import Client

import pytest
import torch

from fiber_tpu.telemetry import export as jax_export
import fiber_tpu_torch
from fiber_tpu_torch.host_agent import cluster_authkey
from fiber_tpu_torch.telemetry import export, tracing
from fiber_tpu_torch.utils import profiling
from tests import _torch_pool_tasks as tasks


def _spans(n_hosts, n_spans):
    return [{"name": ("pool.serialize", "worker.execute",
                      "worker.encode_results")[i % 3],
             "ts": 1.7e9 + 0.01 * i, "dur": 0.001 * (i % 5),
             "host": f"h{i % n_hosts}", "pid": 100 + i % 4,
             "trace": "t1", "span": f"s{i}", "seq": i}
            for i in range(n_spans)]


@pytest.mark.parametrize("n_hosts,n_spans", [(1, 1), (2, 9), (3, 40)])
def test_chrome_trace_equals_the_jax_packages(n_hosts, n_spans):
    spans = _spans(n_hosts, n_spans)
    assert export.chrome_trace(spans) == jax_export.chrome_trace(spans)


SNAPSHOT = {
    "pool_tasks": {"type": "counter", "help": "tasks done",
                   "series": {"": 12.0, "pool=a": 3.0}},
    "queue_depth": {"type": "gauge", "help": "",
                    "series": {"host=h1": 2.5}},
    "chunk_seconds": {"type": "histogram", "help": "chunk wall",
                      "buckets": [0.01, 0.1, 1.0],
                      "series": {"": [1, 2, 3, 4, 5.5, 10],
                                 'op=x"y': [0, 0, 1, 0, 0.5, 1]}},
    "fiber_raw": {"type": "untyped", "series": {"": 7.0}},
}


def test_prometheus_text_equals_the_jax_packages():
    ours = export.prometheus_text(SNAPSHOT)
    assert ours == jax_export.prometheus_text(SNAPSHOT)
    parsed = export.parse_prometheus_text(ours)
    assert parsed == jax_export.parse_prometheus_text(ours)
    assert parsed['fiber_pool_tasks_total{pool="a"}'] == 3.0
    assert parsed['fiber_chunk_seconds_bucket{le="+Inf"}'] == 10
    with pytest.raises(ValueError):
        export.parse_prometheus_text("no_value_here")


def _kineto_doc():
    """A capture shaped like ``torch.profiler``'s Chrome export on a
    card: integer pids for the host process and the card, the string
    pids of Kineto's span rows and window markers, and thread names."""
    return {"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "name": "process_name", "pid": 4242, "tid": 0,
         "ts": 0.0, "args": {"name": "python"}},
        {"ph": "M", "name": "process_labels", "pid": 4242, "tid": 0,
         "ts": 0.0, "args": {"labels": "CPU"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "ts": 0.0, "args": {"name": "python3"}},
        {"ph": "M", "name": "process_labels", "pid": 0, "tid": 0,
         "ts": 0.0, "args": {"labels": "GPU 0"}},
        {"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
         "args": {"name": "stream 7"}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "pid": 4242,
         "tid": 4242, "ts": 10.0, "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "pid": 4242, "tid": 4242, "ts": 11.0, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "flash_fwd_kernel<64>",
         "pid": 0, "tid": 7, "ts": 12.0, "dur": 30.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "pid": 0, "tid": 7, "ts": 43.0, "dur": 2.0},
        {"ph": "X", "cat": "Trace", "name": "PyTorch Profiler (0)",
         "pid": "Spans", "tid": "PyTorch Profiler", "ts": 0.0,
         "dur": 50.0},
        {"ph": "i", "s": "g", "name": "Record Window End", "pid": "",
         "tid": "", "ts": 50.0},
        {}]}


def test_kineto_pids_of_any_type_merge_without_loss(tmp_path):
    """Every event of a Kineto-shaped capture merges, on integer lanes
    past the host rows, named by their labels: the card's lane is
    ``CUDA GPU 0``, the host's ``torch CPU``, the string-pid rows
    ``torch Spans`` and ``torch`` plus their lane number; times are rebased onto the wall start. The
    JAX package's merge of the same capture merges nothing."""
    log_dir = tmp_path / "prof"
    log_dir.mkdir()
    doc = _kineto_doc()
    (log_dir / profiling.TRACE_FILE).write_text(json.dumps(doc))
    (tmp_path / "jax").mkdir()
    (tmp_path / "jax" / "x.trace.json").write_text(json.dumps(doc))
    host = export.chrome_trace(_spans(2, 4))
    wall = 1.7e9
    assert export.merge_xla_trace(host, str(log_dir), wall_start=wall) == 9
    lanes = {e["pid"]: e["args"]["name"] for e in host["traceEvents"]
             if e.get("name") == "process_name"}
    assert sorted(lanes.values()) == [
        "CUDA GPU 0", "h0", "h1", "torch CPU", "torch Spans",
        "torch lane 3"]
    assert all(isinstance(e["pid"], int) and isinstance(e.get("tid", 0),
                                                        int)
               for e in host["traceEvents"])
    kernel = next(e for e in host["traceEvents"]
                  if e["name"].startswith("flash_fwd_kernel"))
    assert lanes[kernel["pid"]].startswith("CUDA ")
    assert kernel["ts"] == wall * 1e6 + 12.0
    jax_host = jax_export.chrome_trace(_spans(2, 4))
    assert jax_export.merge_xla_trace(jax_host, str(tmp_path / "jax"),
                                      wall_start=wall) == 0
    assert export.find_xla_chrome_trace(str(log_dir)).endswith(
        profiling.TRACE_FILE)
    assert jax_export.find_xla_chrome_trace(str(log_dir)) is None


@pytest.mark.parametrize("base_s,wall,want_s", [
    (1.7e9 - 5.0, 1.7e9, 1.7e9 - 5.0),   # the base places the events
    (1.0e9, 1.7e9, 1.7e9),               # a base 22 years off: the start
    (1.7e9 - 5.0, None, 1.7e9 - 5.0),    # no start: the base
], ids=["base", "base_far_off", "no_wall_start"])
def test_kineto_base_time_places_the_events(tmp_path, base_s, wall, want_s):
    """Where the capture states its wall-epoch base, an event sits at
    base + ts; a base far from the given start is ignored."""
    doc = _kineto_doc()
    doc["baseTimeNanoseconds"] = int(base_s * 1e9)
    (tmp_path / profiling.TRACE_FILE).write_text(json.dumps(doc))
    host = export.chrome_trace(_spans(1, 1))
    assert export.merge_xla_trace(host, str(tmp_path), wall_start=wall) == 9
    kernel = next(e for e in host["traceEvents"]
                  if e["name"].startswith("flash_fwd_kernel"))
    assert kernel["ts"] == pytest.approx(want_s * 1e6 + 12.0, abs=1.0)


def test_trace_dump_merges_a_cpu_profiler_capture(tmp_path):
    """``profiling.trace`` around a pool map (torch.profiler with CPU
    activities on this machine): ``Pool.trace_dump`` writes the host
    spans and the profiler's events, with no CUDA lane, in ``torch``
    lanes, and the profiler's events sit on the wall clock."""
    fiber_tpu_torch.init(worker_lite=True)
    try:
        with fiber_tpu_torch.Pool(2) as pool:
            started = time.time()
            with profiling.trace(str(tmp_path / "prof")):
                assert pool.map(tasks.sleep_echo, range(8),
                                chunksize=2) == list(range(8))
                (torch.ones(32, 32) @ torch.ones(32, 32)).sum()
            finished = time.time()
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and sum(
                    s["name"] == "worker.execute"
                    for s in tracing.SPANS.snapshot()) < 4:
                time.sleep(0.05)
            out = pool.trace_dump(str(tmp_path / "merged.json"))
    finally:
        fiber_tpu_torch.init()
    with open(out) as fh:
        doc = json.load(fh)
    events = doc["traceEvents"]
    lanes = {e["pid"]: e["args"]["name"] for e in events
             if e.get("name") == "process_name"}
    profiler = [e for e in events if e.get("ph") != "M"
                and lanes.get(e["pid"], "").startswith("torch ")]
    assert len(profiler) > 0
    assert any(e["name"] == "aten::mm" for e in profiler)
    assert not any(name.startswith("CUDA ") for name in lanes.values())
    assert "worker.execute" in {e["name"] for e in events}
    mm = next(e for e in profiler if e["name"] == "aten::mm")
    assert started < mm["ts"] / 1e6 < finished


def test_metrics_server_text_parses():
    """The port's metrics endpoint answers ``("metrics",)`` with
    Prometheus text that ``parse_prometheus_text`` reads, and
    ``("snapshot",)`` with the registry's snapshot."""
    from fiber_tpu_torch import telemetry

    fiber_tpu_torch.init()
    telemetry.counter("export_test_probe", "a probe").inc(3)
    server = telemetry.serve_metrics()
    try:
        conn = Client(("127.0.0.1", server.port), authkey=cluster_authkey())
        try:
            conn.send(("metrics",))
            ok, text = conn.recv()
            assert ok
            parsed = export.parse_prometheus_text(text)
            assert parsed["fiber_export_test_probe_total"] >= 3
            conn.send(("snapshot",))
            ok, snap = conn.recv()
            assert ok and snap["metrics"]["export_test_probe"][
                "series"][""] >= 3
        finally:
            conn.close()
    finally:
        server.stop()
