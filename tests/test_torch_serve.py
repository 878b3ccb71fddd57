"""The port's serve tier (``fiber_tpu_torch/serve/``, the JAX package's
modules but for the connections): a daemon on localhost with a warm
pool runs a submitted map of CPU-tensor items, ``history`` shows the
job done, its results equal the task's own, and a cancelled job parks
resumable. The client's connection is ``utils/wire.py``'s, so a job's
tensors travel by value: the stdlib connection's pickler, with
``torch.multiprocessing``'s reducers registered, would send a CPU
tensor as a shared-memory file descriptor (and a CUDA tensor as an IPC
handle).

The daemon's warm pool starts worker processes that import torch, so
the file takes about 10 s.
"""

import contextlib
import os
import time

import torch

from fiber_tpu_torch import cli, config
from fiber_tpu_torch.serve import protocol
from fiber_tpu_torch.serve.client import ServeClient
from fiber_tpu_torch.serve.daemon import ServeDaemon
from fiber_tpu_torch.serve.jobs import JobRunner
from fiber_tpu_torch.store import ledger as ledgermod
from fiber_tpu_torch.utils import wire
from tests import _torch_pool_tasks as tasks

#: what a stream may not hold: the shared-memory and CUDA IPC rebuilders
FORBIDDEN = (b"rebuild_storage_fd", b"rebuild_storage_filename",
             b"rebuild_cuda_tensor", b"DupFd")


def _unique_job(tag: str) -> str:
    return f"torch-serve-{tag}-{os.getpid()}-{os.urandom(4).hex()}"


@contextlib.contextmanager
def _daemon(tmp_path, **knobs):
    """An in-process daemon on an ephemeral port with a private job
    journal, and a client of it."""
    cfg = config.get()
    old = {k: getattr(cfg, k) for k in knobs}
    cfg.update(**knobs)
    try:
        runner = JobRunner(processes=2,
                           journal_dir=str(tmp_path / "serve-journal"))
        daemon = ServeDaemon(port=0, runner=runner)
        daemon.start_background()
        client = ServeClient(("127.0.0.1", daemon.port))
        try:
            yield daemon, client
        finally:
            client.close()
            daemon.stop(terminate_pool=True)
    finally:
        cfg.update(**old)


def _until(predicate, deadline_s, what):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def test_submit_tensor_items_then_history_and_results(tmp_path, capsys):
    """A map of CPU-tensor items through the daemon: done, with results
    equal in dtype and value to the task run here, shown as done by
    ``history slo_obs``; the request went out by value."""
    with _daemon(tmp_path, serve_warm_floor=1,
                 serve_tick_s=0.05) as (daemon, client):
        assert client.ping() == "pong"
        assert isinstance(client._conn, wire.Connection)
        sent = []
        send_bytes = client._conn._conn.send_bytes

        def record(data, *args):
            sent.append(bytes(data))
            return send_bytes(data, *args)

        client._conn._conn.send_bytes = record
        items = [(torch.arange(5, dtype=torch.float64) * x, x)
                 for x in range(10)]
        job = client.submit(tasks.tensor_affine, items, tenant="alice",
                            job_id=_unique_job("tensors"), star=True)
        view = client.wait(job, timeout=120)
        assert view["state"] == protocol.DONE, view
        got = client.results(job)
        for (out, where), (t, k) in zip(got, items):
            assert where == "cpu" and out.dtype == torch.float64
            assert torch.equal(out, t * 2 + k)
        assert len(got) == len(items)
        assert sent and not any(word in data for data in sent
                                for word in FORBIDDEN)

        def shown():
            capsys.readouterr()
            assert cli.main(["history", "slo_obs", "--serve",
                             f"127.0.0.1:{daemon.port}"]) == 0
            lines = [ln for ln in capsys.readouterr().out.splitlines()
                     if f"job_id={job}" in ln]
            return lines

        lines = _until(shown, 30, "the job's slo_obs record")
        assert "state=done" in lines[0] and "tenant=alice" in lines[0]


def test_cancel_parks_the_job_resumable(tmp_path, capsys):
    """``cancel`` (the CLI verb) stops a running job: state
    ``cancelled``, its ledger kept and not done; submitting the same job
    id again finishes it."""
    job = _unique_job("cancel")
    with _daemon(tmp_path, serve_warm_floor=1,
                 serve_tick_s=0.05) as (daemon, client):
        client.submit(tasks.sleep_echo, range(60), tenant="alice",
                      job_id=job, chunksize=1)
        _until(lambda: ledgermod.load(ledgermod.job_path(job))[1] or None,
               60, "a first journaled chunk")
        assert cli.main(["cancel", job, "--serve",
                         f"127.0.0.1:{daemon.port}"]) == 0
        assert job in capsys.readouterr().out
        view = client.wait(job, timeout=60)
        assert view["state"] == protocol.CANCELLED, view
        assert not ledgermod.load(ledgermod.job_path(job))[2]
        client.submit(tasks.sleep_echo, range(60), tenant="alice",
                      job_id=job, chunksize=1)
        assert client.wait(job, timeout=120)["state"] == protocol.DONE
        assert client.results(job) == list(range(60))


def test_a_full_card_seen_through_nvml_denies_no_job(tmp_path,
                                                     monkeypatch):
    """A process without a CUDA context (this daemon, a pool master)
    reads its card through NVML only under ``card_hbm``: every process's
    use, an idle warm pool's cached memory included. The ``hbm_fill``
    rule reads this process's own allocator, which is None here, so a
    card NVML reports 99% full raises no anomaly and the daemon, whose
    deny rules name ``hbm_fill``, admits a job. NVML is faked."""
    from fiber_tpu_torch.telemetry import device, monitor

    monkeypatch.setattr(device, "_devices", lambda: None)
    monkeypatch.setattr(device, "_nvml_memory",
                        lambda: (79 << 30, 80 << 30))
    monkeypatch.setattr(device.DEVICE, "enabled", True)
    try:
        device.DEVICE.update_gauges()
        snap = device.DEVICE.snapshot()
        assert snap["hbm"] == {"bytes_in_use": None, "bytes_limit": None}
        assert snap["card_hbm"] == {"bytes_in_use": 79 << 30,
                                    "bytes_limit": 80 << 30}
        assert monitor._hbm_usage() == (0, 0)
        assert monitor._device_summary()["card_hbm"] == snap["card_hbm"]
        monitor.WATCHDOG.observe({
            "wall": time.time(), "mono": time.monotonic(),
            "tasks_per_s": 0.0, "inflight": 0.0, "queue_depth": 0.0,
            "heartbeat_age_s": 0.0, "tx_queue_bytes": 0.0})
        assert "hbm_fill" not in monitor.WATCHDOG.snapshot()["active"]
        with _daemon(tmp_path, serve_warm_floor=1, serve_tick_s=0.05,
                     serve_deny_rules="store_disk_fill,hbm_fill") as (
                         _daemon_obj, client):
            job = client.submit(tasks.square, range(4), tenant="alice",
                                job_id=_unique_job("full-card"))
            assert client.wait(job, timeout=60)["state"] == protocol.DONE
            assert client.results(job) == [0, 1, 4, 9]
            assert "hbm_fill" not in monitor.WATCHDOG.snapshot()["active"]
    finally:
        device.DEVICE.clear()
