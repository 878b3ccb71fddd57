"""Durable maps of the port (``fiber_tpu_torch/store/ledger.py``, a copy
of the JAX package's): task digests and ledger files equal the JAX
package's, a ledger written by either package loads in the other, the
ledger's own semantics (torn tail, ``done`` record, safe job ids), and
resume: a partial ledger re-executes only its remainder, a different
task spec is refused, and a subprocess master SIGKILLed mid-map by the
port's chaos plan is finished by ``fiber_tpu_torch.cli resume``.

The pools here start real worker processes; the tensor tasks import
torch in each worker (a few seconds on a loaded machine), so the file
takes about half a minute.
"""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from fiber_tpu.store import LocalStore as JaxLocalStore
from fiber_tpu.store import ledger as jax_ledger
import fiber_tpu_torch
from fiber_tpu_torch import serialization
from fiber_tpu_torch.store import LocalStore
from fiber_tpu_torch.store import ledger as ledgermod
from fiber_tpu_torch.testing import chaos
from tests import _torch_pool_tasks as tasks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = int(os.environ.get("FIBER_CHAOS_SEED", "7"))


def _unique_job(tag: str) -> str:
    return f"torch-{tag}-{os.getpid()}-{os.urandom(4).hex()}"


def _tensors(x):
    """What ``tasks.sleep_tensors(x)`` returns, without its sleep."""
    return (torch.arange(4, dtype=torch.float64) / 3 + x,
            torch.tensor([x, -x], dtype=torch.int32))


def _equal_results(got, want) -> bool:
    """Equal nests of tensors: the same dtype and the same values."""
    if isinstance(want, torch.Tensor):
        return (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and torch.equal(got, want))
    if isinstance(want, (list, tuple)):
        return (type(got) is type(want) and len(got) == len(want)
                and all(_equal_results(g, w) for g, w in zip(got, want)))
    return got == want


# ---------------------------------------------------------------------------
# digests and files across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("star", [False, True])
@pytest.mark.parametrize("fn", [tasks.square, tasks.sleep_tensors,
                                tasks.cartpole_fitness],
                         ids=lambda f: f.__name__)
def test_task_digests_equal_the_jax_packages(fn, star):
    """A task's identity depends on its import path, item count and call
    shape only, so both packages name one workload alike."""
    assert ledgermod.task_digest(fn, 17, star) \
        == jax_ledger.task_digest(fn, 17, star)
    assert ledgermod.stream_task_digest(fn, star) \
        == jax_ledger.stream_task_digest(fn, star)
    assert ledgermod.task_digest(fn, 17, star) \
        != ledgermod.task_digest(fn, 18, star)


def _write_ledger(module, store, path):
    led = module.MapLedger(path, store, fsync_interval=0.0)
    led.write_header({"job_id": "cross", "task_digest": "td",
                      "n_items": 6, "chunksize": 2, "star": False,
                      "trace": "t-cross", "spec": None})
    for base, values in ((0, [0, 1]), (2, [4, 9]), (4, [16, 25])):
        assert led.record_chunk(base, 2, values)
    led.record_done()
    assert led.flush(10.0)
    led.close()
    with open(path) as fh:
        return fh.read()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_ledger_loads_in_the_other_package(tmp_path, writer):
    """The same records make the same file in both packages (the chunk
    payloads of plain values serialize alike, so their digests agree),
    and the file one package writes loads in the other with the same
    header fields, chunks and ``done`` flag; the chunk payloads restore
    from the writer's store."""
    ours = _write_ledger(ledgermod, LocalStore(root=str(tmp_path / "a")),
                         str(tmp_path / "port.ledger"))
    theirs = _write_ledger(jax_ledger,
                           JaxLocalStore(root=str(tmp_path / "b")),
                           str(tmp_path / "jax.ledger"))
    assert ours == theirs
    path = str(tmp_path / f"{writer}.ledger")
    got = ledgermod.load(path)
    want = jax_ledger.load(path)
    assert got == want
    header, completed, done = got
    assert header == {"job_id": "cross", "task_digest": "td",
                      "n_items": 6, "chunksize": 2, "star": False,
                      "trace": "t-cross", "spec": None, "kind": "map",
                      "v": ledgermod.LEDGER_VERSION}
    assert sorted(completed) == [0, 2, 4] and done
    store = LocalStore(root=str(tmp_path / ("a" if writer == "port"
                                            else "b")))
    assert [serialization.loads(store.get_bytes(completed[b][1]))
            for b in (0, 2, 4)] == [[0, 1], [4, 9], [16, 25]]


# ---------------------------------------------------------------------------
# the ledger's own semantics
# ---------------------------------------------------------------------------


def test_job_id_path_safety():
    for bad in ("../evil", "", "a/b", "x" * 129, "sp ace"):
        with pytest.raises(ValueError):
            ledgermod.check_job_id(bad)
    assert ledgermod.check_job_id("es-gen_42.A") == "es-gen_42.A"
    assert ledgermod.job_path("es-gen_42.A", "/d") == "/d/es-gen_42.A.ledger"


def test_ledger_roundtrip_dedup_and_torn_tail(tmp_path):
    """A duplicate chunk is journaled once; a torn last record (the
    crash landed mid-append) is skipped and everything before it loads;
    tensor payloads restore by digest as tensors; a ledger reopened on
    the torn file terminates the torn line before appending."""
    store = LocalStore(root=str(tmp_path / "objects"))
    path = str(tmp_path / "j.ledger")
    led = ledgermod.MapLedger(path, store, fsync_interval=0.0)
    led.write_header({"job_id": "j", "task_digest": "td", "n_items": 8,
                      "chunksize": 2, "star": False, "trace": "abc"})
    values = [_tensors(x) for x in (0, 1)]
    assert led.record_chunk(0, 2, values)
    assert not led.record_chunk(0, 2, values)
    assert led.record_chunk(2, 2, [3, 4])
    assert led.flush(10.0)
    assert led.chunks_journaled == 2
    led.close()
    with open(path, "a") as fh:
        fh.write('{"kind": "chunk", "base": 4, "n"')
    header, completed, done = ledgermod.load(path)
    assert header["trace"] == "abc" and header["chunksize"] == 2
    assert sorted(completed) == [0, 2] and not done
    assert _equal_results(
        serialization.loads(store.get_bytes(completed[0][1])), values)
    again = ledgermod.MapLedger(path, store, fsync_interval=0.0)
    again.record_chunk(4, 2, [5, 6])
    again.record_done()
    again.close()
    _, completed, done = ledgermod.load(path)
    assert sorted(completed) == [0, 2, 4] and done


def test_ledger_done_record(tmp_path):
    store = LocalStore(root=str(tmp_path / "objects"))
    path = str(tmp_path / "d.ledger")
    led = ledgermod.MapLedger(path, store, fsync_interval=0.0)
    led.write_header({"job_id": "d", "task_digest": "t", "n_items": 2,
                      "chunksize": 2, "star": False, "trace": None})
    led.record_chunk(0, 2, ["a", "b"])
    led.record_done()
    led.close()
    _, completed, done = ledgermod.load(path)
    assert done and list(completed) == [0]
    assert ledgermod.list_jobs(str(tmp_path)) == ["d"]


# ---------------------------------------------------------------------------
# resume through the pool
# ---------------------------------------------------------------------------


def test_resume_partial_ledger_executes_only_remainder():
    """Truncating a finished map's journal to 8 of its 12 chunk records
    (the state a crash at that point leaves) makes the same map with the
    same job id execute the 4 chunks left and restore the rest: CPU
    tensors equal, in dtype and value, to the first run's."""
    job = _unique_job("resume-part")
    xs = list(range(24))
    with fiber_tpu_torch.Pool(2) as pool:
        want = pool.map(tasks.sleep_tensors, xs, chunksize=2, job_id=job)
    path = ledgermod.job_path(job)
    with open(path) as fh:
        records = [json.loads(ln) for ln in fh if ln.strip()]
    header = [r for r in records if r["kind"] == "map"]
    chunks = [r for r in records if r["kind"] == "chunk"]
    assert len(chunks) == 12
    with open(path, "w") as fh:
        for rec in header + chunks[:8]:
            fh.write(json.dumps(rec) + "\n")
    with fiber_tpu_torch.Pool(2) as pool:
        got = pool.map(tasks.sleep_tensors, xs, chunksize=2, job_id=job)
        stats = pool.stats()
        info = pool.ledger_stats()
    assert _equal_results(got, want)
    assert stats["tasks_restored"] == 16
    assert stats["tasks_completed"] == len(xs) - 16
    assert info["restored_chunks"] == 8 and info["pending_chunks"] == 4
    _, completed, done = ledgermod.load(path)
    assert done and len(completed) == 12


def test_resume_rejects_different_task_spec():
    job = _unique_job("resume-reject")
    with fiber_tpu_torch.Pool(2) as pool:
        pool.map(tasks.square, list(range(8)), job_id=job)
        with pytest.raises(ValueError, match="different task spec"):
            pool.map(tasks.square, list(range(9)), job_id=job)


def test_master_sigkill_mid_map_then_cli_resume(tmp_path, capsys):
    """The crash drill of the JAX package's durable tests, on the port:
    a subprocess master mapping a task that returns CPU tensors is
    SIGKILLed by the port's ``kill_master_after_chunks`` once >= 3
    chunks are journaled; ``fiber_tpu_torch.cli resume`` finishes the
    map. Restored plus executed tasks make the total, the journaled
    chunks are restored and not run again, the trace id survives, and
    every result equals the uninterrupted map's in dtype and value.

    The results come back as CPU tensors because they were CPU tensors:
    the ledger's writer thread serializes each chunk by value (for CUDA
    results, a copy to the host on that thread), and a resumed CUDA
    tensor is rebuilt on the current CUDA device of the resuming
    process, which raises where it has none (``chip_smoke.py``'s
    ``durable`` phase resumes CUDA results on the card)."""
    job = _unique_job("crash")
    plan = chaos.install(chaos.ChaosPlan(
        seed=SEED, token_dir=str(tmp_path / "tokens"),
        kill_master_after_chunks=3, kill_master_times=1))
    # torch is imported before the map, so that the master's first
    # tensor result does not stall the result loop behind the import
    # while every chunk completes
    script = (
        "import torch\n"
        "import fiber_tpu_torch\n"
        "from tests import _torch_pool_tasks as tasks\n"
        "fiber_tpu_torch.init(worker_lite=True)\n"
        "with fiber_tpu_torch.Pool(2) as pool:\n"
        "    pool.map(tasks.sleep_tensors, list(range(48)), chunksize=2,\n"
        f"             job_id={job!r})\n")
    env = dict(os.environ, FIBER_BACKEND="local")
    try:
        proc = subprocess.run([sys.executable, "-c", script], env=env,
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=240)
    finally:
        chaos.uninstall()
    assert proc.returncode == -9, (proc.returncode, proc.stderr[-2000:])
    assert plan.spent("kill-master") == 1
    header, completed, done = ledgermod.load(ledgermod.job_path(job))
    assert not done
    journaled = len(completed)
    assert 3 <= journaled < 24
    time.sleep(1.0)  # the orphaned workers notice the dead master
    from fiber_tpu_torch import cli

    out_path = str(tmp_path / "results.bin")
    capsys.readouterr()
    assert cli.main(["resume", job, "--processes", "2",
                     "--out", out_path]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["tasks"] == 48
    assert summary["restored_chunks"] == journaled
    assert summary["restored_tasks"] == 2 * journaled
    assert summary["executed_tasks"] == 48 - 2 * journaled
    assert summary["trace"] == header["trace"]
    with open(out_path, "rb") as fh:
        results = serialization.loads(fh.read())
    assert _equal_results(results, [_tensors(x) for x in range(48)])
    _, completed_after, done_after = ledgermod.load(ledgermod.job_path(job))
    assert done_after and len(completed_after) == 24
