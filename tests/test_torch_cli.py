"""The port's CLI (``python -m fiber_tpu_torch.cli``, the
``fiber-tpu-torch`` console script): the JAX package's commands and
options, the same renderings of one snapshot, ``jobs``, ``cost``,
``explain`` and ``resume`` on the port's artifacts, and ``doctor``'s
CUDA probe, which on a machine without a card reports none and on a
hung driver retries with every card hidden.

The pool maps here start worker processes, so the file takes about
15 s.
"""

import argparse
import json
import os
import time

import pytest

from fiber_tpu import cli as jax_cli
import fiber_tpu_torch
from fiber_tpu_torch import cli
from fiber_tpu_torch.store import ledger as ledgermod
from fiber_tpu_torch.telemetry import tracing
from tests import _torch_pool_tasks as tasks


def _unique_job(tag: str) -> str:
    return f"torch-cli-{tag}-{os.getpid()}-{os.urandom(4).hex()}"


def _commands(parser):
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: sorted(
        (tuple(a.option_strings), a.dest, repr(a.default),
         repr(a.choices), repr(a.nargs))
        for a in p._actions) for name, p in sub.choices.items()}


def test_the_parser_has_the_jax_clis_commands_and_options():
    ours, theirs = _commands(cli.build_parser()), \
        _commands(jax_cli.build_parser())
    assert sorted(ours) == sorted(theirs)
    assert {"resume", "jobs", "doctor", "serve", "submit", "cancel",
            "history", "explain", "devices", "top"} <= set(ours)
    for name in theirs:
        assert ours[name] == theirs[name], name
    assert cli.build_parser().prog == "fiber-tpu-torch"


TOP_PULLS = {
    "10.0.0.1:7000": {
        "timeseries": {"last": {"tasks_per_s": 812.5, "inflight": 7,
                                "queue_depth": 3,
                                "bytes_tx_per_s": 3.5e6,
                                "bytes_rx_per_s": 1200.0}},
        "anomalies": {"active": {"hbm_fill": {}, "straggler": {}}},
        "heartbeat_ages": {"w1": 0.25, "w2": 1.5},
        "device": {"hbm_bytes_in_use": 3 << 30,
                   "hbm_bytes_limit": 80 << 30, "mfu": 0.0123,
                   "dev_store_bytes": 5 << 20, "dev_store_demoted": True}},
    "10.0.0.2:7000": {"timeseries": {"last": {}}, "device": {}},
    "10.0.0.3:7000": {"error": "ConnectionRefusedError()"},
}
DEVICE_PULLS = {
    "10.0.0.1:7000": {"platform": "gpu", "transfer_bytes": 8 << 20,
                      "transfer_seconds": 0.0125, "compiles": 3,
                      "compile_seconds": 1.5,
                      "hbm": {"bytes_in_use": 1 << 30,
                              "bytes_limit": 80 << 30},
                      "live_arrays": {"count": None, "bytes": 1 << 30},
                      "mfu": {"mfu": 0.5}, "recompile": {"storm": True}},
    "10.0.0.2:7000": {"platform": None, "hbm": {}, "mfu": {}},
    "10.0.0.3:7000": {"error": "timeout"},
}
COST_PULLS = {
    "10.0.0.1:7000": {"costs": {"tenant=a,job=j1": {
        "tasks": 40, "cpu_s": 2.5, "wall_s": 3.0, "wire_tx": 1e6,
        "wire_rx": 2e6, "device_s": 0.25}, "tenant=-,job=-": {}}},
    "10.0.0.2:7000": {"costs": {}},
}


@pytest.mark.parametrize("render,pulls", [
    ("_render_top_rows", TOP_PULLS), ("_render_device_rows", DEVICE_PULLS),
    ("_render_cost_rows", COST_PULLS)], ids=["top", "devices", "costs"])
def test_both_clis_render_one_snapshot_alike(render, pulls):
    ours = getattr(cli, render)(pulls)
    assert ours == getattr(jax_cli, render)(pulls)
    assert len(ours) >= len(pulls)
    assert cli._TOP_HEADER == jax_cli._TOP_HEADER
    assert cli._DEVICES_HEADER == jax_cli._DEVICES_HEADER


def test_an_agents_nvml_reading_renders_as_numbers(monkeypatch):
    """A process without a CUDA context (a host agent) reports its
    card's memory through NVML under ``card_hbm``, so ``devices`` and
    ``top`` show numbers in the HBM column, marked '*' as the card's;
    its own ``hbm`` pair stays None. The NVML library is faked here."""
    from fiber_tpu_torch.telemetry import device

    class FakeNvml:
        def nvmlDeviceGetHandleByIndex_v2(self, index, handle):
            assert index.value == 1
            return 0

        def nvmlDeviceGetMemoryInfo(self, handle, mem):
            mem._obj.total, mem._obj.used = 80 << 30, 5 << 30
            return 0

    monkeypatch.setattr(device, "_nvml", FakeNvml())
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "1,0")
    monkeypatch.setattr(device, "_devices", lambda: None)
    assert device._nvml_memory() == (5 << 30, 80 << 30)
    card = {"bytes_in_use": 5 << 30, "bytes_limit": 80 << 30}
    assert device._card_hbm_stats() == card
    assert device._hbm_stats() == {"bytes_in_use": None,
                                   "bytes_limit": None}
    snap = {"platform": None, "hbm": device._hbm_stats(), "mfu": {},
            "card_hbm": card}
    row = cli._render_device_rows({"h:1": snap})[0]
    assert "5.0GB/80.0GB*" in row
    pull = {"device": {"hbm_bytes_in_use": None, "hbm_bytes_limit": None,
                       "card_hbm": card}}
    assert "5.0GB/80.0GB*" in cli._render_top_rows({"h:1": pull})[0]
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    assert device._nvml_memory() is None
    monkeypatch.setattr(device, "_nvml", False)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES")
    assert device._card_hbm_stats() is None
    snap["card_hbm"] = None
    assert " - " in cli._render_device_rows({"h:1": snap})[0]


def test_doctor_reports_no_cuda_device_here(capsys):
    """On a machine without a card the probe says so, as an ok line:
    host work needs no card."""
    t0 = time.monotonic()
    assert cli.main(["doctor", "--timeout", "120"]) == 0
    out = capsys.readouterr().out
    assert time.monotonic() - t0 < 120
    line = next(ln for ln in out.splitlines() if "cuda devices" in ln)
    assert line.startswith("[ok  ]") and "platform=cpu count=0" in line
    assert "jax" not in out.lower() and "doctor: healthy" in out


@pytest.mark.parametrize("hidden_ok", [True, False])
def test_doctor_probe_hang_retries_with_cards_hidden(monkeypatch, capsys,
                                                     hidden_ok):
    """A probe that hangs is retried with ``CUDA_VISIBLE_DEVICES=""``:
    if that answers, the driver is named as the cause."""
    monkeypatch.setattr(cli, "_CUDA_PROBE", (
        "import json, os, time\n"
        f"if os.environ.get('CUDA_VISIBLE_DEVICES') != '' or not "
        f"{hidden_ok}:\n"
        "    time.sleep(30)\n"
        "print(json.dumps(['cpu', 0, None]))\n"))
    assert cli.main(["doctor", "--timeout", "2"]) == 1
    line = next(ln for ln in capsys.readouterr().out.splitlines()
                if "cuda devices" in ln)
    assert line.startswith("[FAIL]")
    assert ("driver is wedged" in line) == hidden_ok
    assert ("even with every card hidden" in line) == (not hidden_ok)


def test_jobs_cost_explain_and_resume_on_the_ports_artifacts(tmp_path,
                                                             capsys):
    """One traced durable map, then the CLI on what it left: ``jobs``
    lists its ledger as done, ``cost`` renders its record, ``explain``
    joins its ``trace_dump`` and ``flight_dump`` into a blame verdict,
    and ``resume`` restores all of it without running a task."""
    job = _unique_job("artifacts")
    fiber_tpu_torch.init(worker_lite=True)
    try:
        with fiber_tpu_torch.Pool(2) as pool:
            assert pool.map(tasks.sleep_echo, range(12), chunksize=2,
                            job_id=job, tenant="acme") == list(range(12))
            deadline = time.monotonic() + 20
            while time.monotonic() < deadline and sum(
                    s["name"] == "worker.execute"
                    for s in tracing.SPANS.snapshot()) < 6:
                time.sleep(0.05)
            trace = pool.trace_dump(str(tmp_path / "trace.json"))
            flight = pool.flight_dump(str(tmp_path / "flight.json"))
    finally:
        fiber_tpu_torch.init()

    def listed():
        capsys.readouterr()
        assert cli.main(["jobs", "--tenant", "acme"]) == 0
        out = capsys.readouterr().out
        return out if job in out else None

    out = None
    deadline = time.monotonic() + 30
    while out is None and time.monotonic() < deadline:
        out = listed()  # the cost record lands asynchronously
        time.sleep(0.1)
    assert out is not None, "the job never showed under --tenant acme"
    row = next(ln for ln in out.splitlines() if job in ln)
    assert "tenant=acme" in row and "done" in row
    assert cli.main(["cost", job, "--json"]) == 0
    record = json.loads(capsys.readouterr().out)
    assert record["job_id"] == job and record["tenant"] == "acme"
    assert cli.main(["explain", trace, "--flight", flight]) == 0
    verdict = capsys.readouterr().out
    assert "primary:" in verdict and "ranked budget" in verdict
    out_path = str(tmp_path / "results.bin")
    assert cli.main(["resume", job, "--processes", "2",
                     "--out", out_path]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["tasks"] == 12 and summary["executed_tasks"] == 0
    assert summary["restored_chunks"] == 6
    header, _, done = ledgermod.load(ledgermod.job_path(job))
    assert done and summary["trace"] == header["trace"]
