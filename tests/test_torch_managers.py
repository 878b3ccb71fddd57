"""The port's managers (``fiber_tpu_torch.Manager``, ``AsyncManager``)
on the CPU: the cases of ``tests/test_managers.py``, the shared
containers held against the JAX package's manager, and tensors, which
travel by value.

Each case starts a manager process, and the cross-process ones one or
two ``fiber_tpu_torch.Process`` children (about a second each: a fresh
interpreter). The async case waits out four 1 s calls.
"""

import threading
import time

import numpy as np
import pytest
import torch

import fiber_tpu
import fiber_tpu_torch
from fiber_tpu_torch.managers import (AsyncBaseProxy, AsyncManager,
                                      MakeProxyType)
from tests import _torch_manager_tasks as tasks


def _containers(manager):
    """The same operations on a manager's list, dict, Namespace and
    Value, and what each returned."""
    seen = []
    lst = manager.list([1, 2])
    lst.append(3)
    seen += [lst[2], len(lst), list(lst)]
    d = manager.dict({"a": 1})
    d["b"] = 2
    seen += [d["a"], sorted(d.keys()), "b" in d, d.get("z", 9)]
    ns = manager.Namespace()
    ns.x = 42
    seen.append(ns.x)
    v = manager.Value("i", 7)
    seen.append(v.value)
    v.value = 8
    seen.append(v.get())
    # nested values are copies; reassignment through the proxy persists
    nested = manager.list([{"k": 1}, [1, 2]])
    inner = nested[0]
    inner["k"] = 99
    seen.append(nested[0]["k"])
    nested[0] = inner
    seen.append(nested[0]["k"])
    return seen


@pytest.fixture
def manager():
    m = fiber_tpu_torch.Manager()
    yield m
    m.shutdown()


def test_containers_and_nesting_match_the_jax_packages(manager):
    jax_manager = fiber_tpu.Manager()
    try:
        want = _containers(jax_manager)
    finally:
        jax_manager.shutdown()
    got = _containers(manager)
    assert got == want
    assert got == [3, 3, [1, 2, 3], 1, ["a", "b"], True, 9, 42, 7, 8, 1, 99]


def test_remote_exception(manager):
    d = manager.dict({})
    with pytest.raises(KeyError):
        d["missing"]


def _start_all(procs):
    for p in procs:
        p.start()
    return procs


def _join_all(procs, timeout=60):
    for p in procs:
        p.join(timeout)
        assert p.exitcode == 0, (p.name, p.exitcode)


@pytest.mark.parametrize("case", ["list", "queue", "tensor"])
def test_proxy_across_processes(manager, case):
    """Proxies pickle into port processes and act on the same object:
    two children append to one list; a child drains a managed queue;
    two children put tensors into one dict, which come back equal to
    the ones made from the same seeds here (about 5 s: the children and
    the manager's server import torch)."""
    P = fiber_tpu_torch.Process
    if case == "list":
        lst = manager.list([])
        _join_all(_start_all([P(target=tasks.list_appender, args=(lst, 5))
                              for _ in range(2)]))
        assert sorted(lst) == sorted(list(range(5)) * 2)
    elif case == "queue":
        q = manager.Queue()
        out = fiber_tpu_torch.SimpleQueue()
        procs = _start_all([P(target=tasks.queue_consumer,
                              args=(q, out, 10))])
        for i in range(10):
            q.put(i)
        assert out.get(30) == sum(range(10))
        _join_all(procs)
    else:
        d = manager.dict()
        _join_all(_start_all([P(target=tasks.tensor_writer,
                                args=(d, f"t{s}", s)) for s in (1, 2)]))
        for s in (1, 2):
            want = torch.randn(4, 3,
                               generator=torch.Generator().manual_seed(s))
            assert torch.equal(d[f"t{s}"], want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64"])
def test_tensor_through_a_managed_dict(manager, dtype):
    """A CPU tensor put into a managed dict comes back equal, of its
    dtype and shape, on the CPU; by value, so an in-place change on the
    sender after the put leaves the managed copy as it was, and a
    ``Parameter`` comes back a ``Parameter``."""
    g = torch.Generator().manual_seed(0)
    t = (torch.randn(5, 7, generator=g) * 100).to(getattr(torch, dtype))
    d = manager.dict()
    d["t"] = t
    d["p"] = torch.nn.Parameter(t.float())
    kept = t.clone()
    t.add_(1)
    back = d["t"]
    assert back.dtype == kept.dtype and back.device.type == "cpu"
    assert torch.equal(back, kept)
    p = d["p"]
    assert isinstance(p, torch.nn.Parameter) and torch.equal(p, kept.float())
    # numpy values beside them are untouched by the tensor path
    d["a"] = np.arange(6.0)
    assert np.array_equal(d["a"], np.arange(6.0))


def test_async_manager_parallel_calls():
    """4 async 1 s calls on one manager must overlap: total < 2.5 s."""
    AsyncManager.register(
        "SlowWorker", tasks.SlowWorker,
        MakeProxyType("AsyncSlowWorkerProxy", ("step",),
                      base=AsyncBaseProxy))
    manager = fiber_tpu_torch.AsyncManager()
    try:
        workers = [manager.SlowWorker() for _ in range(4)]
        t0 = time.time()
        futures = [w.step(i) for i, w in enumerate(workers)]
        results = [f.get(30) for f in futures]
        elapsed = time.time() - t0
        assert results == [100, 101, 102, 103]
        assert elapsed < 2.5, f"async calls did not overlap: {elapsed:.2f}s"
        # an async dict hands a tensor back as a future's value
        d = manager.dict()
        d.__setitem__("t", torch.arange(4)).get(30)
        assert torch.equal(d.__getitem__("t").get(30), torch.arange(4))
    finally:
        manager.shutdown()


@pytest.mark.parametrize("primitive",
                         ["lock", "semaphore", "barrier", "condition"])
def test_sync_primitives(manager, primitive):
    """Lock: two children's 25 locked increments each all land.
    Semaphore: two slots, then a non-blocking acquire fails; a blocked
    acquire on one thread is released from another through the same
    proxy. Barrier: two children and this process pass it once each.
    Condition: a child parks in ``wait`` until this process notifies."""
    P = fiber_tpu_torch.Process
    if primitive == "lock":
        lock, ns = manager.Lock(), manager.Namespace()
        ns.counter = 0
        _join_all(_start_all([P(target=tasks.locked_increment,
                                args=(lock, ns, 25)) for _ in range(2)]))
        assert ns.counter == 50
    elif primitive == "semaphore":
        sem = manager.Semaphore(2)
        assert sem.acquire() is True and sem.acquire() is True
        assert sem.acquire(False) is False
        got = {}
        t = threading.Thread(target=lambda: got.setdefault(
            "ok", sem.acquire(True)))
        t.start()
        time.sleep(0.3)
        assert "ok" not in got
        sem.release()
        t.join(10)
        assert got.get("ok") is True
    elif primitive == "barrier":
        barrier, q = manager.Barrier(3), fiber_tpu_torch.SimpleQueue()
        procs = _start_all([P(target=tasks.barrier_then_report,
                              args=(barrier, q, i)) for i in range(2)])
        barrier.wait()
        assert sorted(q.get(30) for _ in range(2)) == [0, 1]
        _join_all(procs)
        q.close()
    else:
        cond, ns = manager.Condition(), manager.Namespace()
        ns.ready = False
        out = fiber_tpu_torch.SimpleQueue()
        procs = _start_all([P(target=tasks.condition_consumer,
                              args=(cond, ns, out))])
        time.sleep(1.0)
        assert out.empty()
        with cond:
            ns.ready = True
            cond.notify_all()
        assert out.get(30) == "saw ready"
        _join_all(procs)
