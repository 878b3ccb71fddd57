"""Hierarchical dispatch in the port (``fiber_tpu_torch/sched/hier.py``,
a copy of the JAX package's): with ``cpu_per_job=2`` and
``dispatch_mode="hier"`` a pool's packed job becomes a sub-master that
fetches chunk ranges and forks its sub-workers. The maps here return
what a direct pool returns, for ints and for CPU tensors, range
handouts are counted, and a SIGKILL of the sub-master mid-map loses no
task.

Each pool starts one worker process that forks two sub-workers; the
tensor map imports torch in them, so the file takes about 20 s.
"""

import time

import pytest
import torch

import fiber_tpu_torch
from fiber_tpu_torch import telemetry
from tests import _torch_pool_tasks as tasks


@pytest.fixture(autouse=True)
def _restore_config():
    yield
    fiber_tpu_torch.init()  # drop the dispatch_mode/cpu_per_job overrides


def _hier_pool(n=2):
    fiber_tpu_torch.init(worker_lite=True, cpu_per_job=2,
                         dispatch_mode="hier")
    return fiber_tpu_torch.Pool(n)


def _ranges() -> float:
    return telemetry.REGISTRY.counter("sched_decisions").value(kind="range")


@pytest.mark.parametrize("kind", ["ints", "cpu_tensors"])
def test_hier_pool_returns_what_a_direct_pool_returns(kind):
    """The same map through a direct pool and a hier pool: equal
    results (tensors in dtype and value), a sub-master that declared
    itself, and range handouts counted as scheduling decisions."""
    if kind == "ints":
        fn, items = tasks.square, [(x,) for x in range(120)]
    else:
        fn = tasks.tensor_affine
        items = [(torch.arange(6, dtype=torch.float64) * x, x)
                 for x in range(24)]
    fiber_tpu_torch.init(worker_lite=True)
    with fiber_tpu_torch.Pool(2) as pool:
        want = pool.starmap(fn, items, chunksize=1)
    ranges0 = _ranges()
    with _hier_pool(2) as pool:
        got = pool.starmap(fn, items, chunksize=1)
        assert pool._hier_idents, "no sub-master declared itself"
        assert not pool._hier_degraded
    assert _ranges() > ranges0
    if kind == "ints":
        assert got == want == [x * x for (x,) in items]
    else:
        for (out, where), (ref, _), (t, k) in zip(got, want, items):
            assert where == "cpu" and out.dtype == torch.float64
            assert torch.equal(out, ref) and torch.equal(out, t * 2 + k)


def test_hier_submaster_kill9_loses_zero_tasks():
    """SIGKILL of the sub-master once it holds work: every chunk of its
    ranges is reclaimed and resubmitted, the map completes with every
    result, and the pool falls back to direct dispatch for that host."""
    with _hier_pool(2) as pool:
        xs = list(range(240))
        res = pool.map_async(tasks.sleep_echo, xs, chunksize=2)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                not pool._hier_idents or pool._n_completed < 10):
            time.sleep(0.02)
        assert pool._hier_idents and pool._n_completed >= 10
        with pool._workers_lock:
            victim = pool._workers[0]
        victim.kill()
        assert res.get(240) == xs, "tasks lost across the sub-master kill"
        assert pool._hier_degraded
        assert pool.stats()["chunks_resubmitted"] > 0
