"""The port's ``Ring`` (``fiber_tpu_torch.parallel.ring``) with its two
initializers, on the CPU, against the JAX package.

* ``HostRing``: 3 rank processes allreduce 257-long f32 arrays made from
  a numpy seed (odd length: uneven chunks). The numpy sums and means
  must equal, bit for bit, the JAX package's ``HostRing`` on the same
  inputs (its 3 ranks run as threads of this process over local
  sockets: the reduction is numpy in both, with the same chunking and
  hop order). A tensor in gives a tensor out, equal to the numpy result.
* ``torch_distributed_initializer``: 2 rank processes joined over gloo
  reduce across processes, and a process mesh spans them.
* The ES across 2 gloo processes equals, exactly, the single-process
  2-rank mesh's ES from the same seed: every rank draws the same
  generation, rolls out its own rows and sums the gradient across the
  processes, and on the CPU the rollouts of 8 rows agree with those of
  16 bit for bit.

Each process test starts a manager and 2-3 rank processes (a few
seconds each: every rank is a fresh interpreter; the gloo ones import
torch).
"""

import functools
import socket
import threading

import numpy as np
import pytest
import torch

import fiber_tpu_torch
from fiber_tpu.ops.collectives import HostRing as JaxHostRing
from fiber_tpu_torch.examples import pod_es_ring
from fiber_tpu_torch.parallel import Ring
from fiber_tpu_torch.parallel.mesh import make_mesh
from fiber_tpu_torch.parallel.ring import torch_distributed_initializer
from tests import _torch_ring_tasks as tasks

INPUTS = [np.random.default_rng(0).standard_normal(257).astype(np.float32)
          * (r + 1) for r in range(3)]


def _run_ring(size, func, **kw):
    """Runs ``func(rank, size, results=)`` on a ``Ring`` of ``size``,
    ``results`` a managed dict, and returns ``{rank: what it wrote}``."""
    manager = fiber_tpu_torch.Manager()
    try:
        results = manager.dict()
        Ring(size, functools.partial(func, results=results), **kw).run()
        return {r: results[r] for r in range(size)}
    finally:
        manager.shutdown()


def _jax_ring(inputs, op):
    """The JAX package's HostRing over ``len(inputs)`` threads."""
    n = len(inputs)
    listeners = []
    for _ in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        s.listen(2)
        listeners.append(s)
    addrs = [("127.0.0.1", s.getsockname()[1]) for s in listeners]
    out = [None] * n

    def rank(r):
        ring = JaxHostRing(r, n, addrs, listener=listeners[r])
        out[r] = ring.allreduce(inputs[r], op=op)
        ring.close()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return out


@pytest.fixture(scope="module")
def host_ring():
    return _run_ring(3, functools.partial(tasks.host_ring_rank,
                                          inputs=INPUTS))


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_host_ring_numpy_equals_the_jax_packages_bitwise(host_ring, op):
    """Every rank ends with the JAX HostRing's result, bit for bit; the
    sums differ from a plain ``np.sum`` in rounding, so the chunking and
    the hop order are what is held."""
    want = _jax_ring(INPUTS, op)
    for r, got in host_ring.items():
        assert isinstance(got[op], np.ndarray) and got[op].dtype == np.float32
        assert got[op].tobytes() == want[r].tobytes()
        assert got[op].tobytes() == want[0].tobytes()
    plain = np.sum(INPUTS, axis=0, dtype=np.float32)
    assert np.allclose(host_ring[0]["sum"], plain, atol=1e-5)


@pytest.mark.parametrize("op", ["sum", "mean"])
def test_host_ring_tensor_in_tensor_out(host_ring, op):
    """A CPU tensor comes back a CPU f32 tensor, equal to the numpy path
    bit for bit; the ranks reached the ring without torch."""
    for got in host_ring.values():
        t = got[f"{op}_t"]
        assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
        assert t.device.type == "cpu"
        assert t.numpy().tobytes() == got[op].tobytes()
        assert got["torch_before"] is False


def test_host_ring_broadcast(host_ring):
    for got in host_ring.values():
        assert torch.equal(got["broadcast_t"],
                           torch.from_numpy(INPUTS[1]) * 2)


def test_ring_data_parallel_sgd():
    Ring(2, tasks.sgd_rank).run()


def test_ring_allreduce_example_converges():
    from fiber_tpu_torch.examples import ring_allreduce

    Ring(2, ring_allreduce.sgd_rank).run()


def test_ring_forwards_meta_hints(monkeypatch):
    """Rank processes inherit the ring function's @meta hints even though
    their direct target is the rendezvous shim (reference:
    fiber/experimental/ring.py:78-82)."""
    import fiber_tpu_torch.process

    created = []

    class FakeProcess:
        def __init__(self, *a, **kw):
            created.append(kw)
            self.name = kw.get("name", "")
            self.exitcode = 0

        def start(self):
            pass

        def join(self, timeout=None):
            pass

    class FakeManager:
        def list(self, seed):
            return list(seed)

        def shutdown(self):
            pass

    monkeypatch.setattr(fiber_tpu_torch.process, "Process", FakeProcess)
    monkeypatch.setattr(fiber_tpu_torch, "Manager", FakeManager)

    @fiber_tpu_torch.meta(cpu=3, memory=512)
    def ranked(rank, size):
        pass

    ring = Ring(2, ranked, initializer=None)
    ring.run()
    assert len(created) == 2
    assert all(kw["meta_hints"] == {"cpu": 3, "mem": 512} for kw in created)
    assert [kw["args"][0] for kw in created] == [0, 1]


def test_torch_distributed_initializer_joins_gloo_ranks():
    got = _run_ring(2, tasks.dist_rank,
                    initializer=torch_distributed_initializer)
    own = [torch.arange(3.0) + 10 * r for r in range(2)]
    for r, out in got.items():
        assert (out["world"], out["rank"], out["backend"]) == (2, r, "gloo")
        assert torch.equal(out["all_reduce"], torch.full((5,), 3.0))
        assert out["mesh"] == (2, r)
        assert torch.equal(out["psum"], own[0] + own[1])
        assert torch.equal(out["pmean"], (own[0] + own[1]) / 2)
        assert torch.equal(out["all_gather"], torch.stack(own))


def test_gloo_store_port_cannot_be_taken_before_the_join():
    """Each rank tries to bind the port rank 0 advertised for its TCP
    store before joining, as another process of the machine may: the
    port is already held by rank 0's listener, so no rank gets it and
    the join succeeds. (While the store bound an advertised random port
    itself, a process that took the port first failed rank 0's join.)"""
    got = _run_ring(2, tasks.squatted_dist_rank,
                    initializer=tasks.squat_then_join)
    for r in range(2):
        assert got[r]["port_taken"] is False
        assert (got[r]["world"], got[r]["rank"]) == (2, r)
        assert torch.equal(got[r]["all_reduce"], torch.full((5,), 3.0))


def test_es_across_gloo_processes_equals_the_two_rank_mesh():
    """MLP (8,), pop 16, 20-step episodes, 2 generations of ``run_fused``
    on each of 2 gloo processes: the params are replicated (a digest
    spread of 0) and equal the single-process 2-rank mesh's, as do the
    stats. About 5 s: both ranks import torch and join over gloo."""
    kw = dict(pop=16, steps=20, hidden=(8,), generations=2)
    got = _run_ring(2, functools.partial(pod_es_ring.train_rank,
                                         device="cpu", **kw),
                    initializer=torch_distributed_initializer)
    es, params = pod_es_ring.flagship_es(make_mesh("cpu", n=2), kw["pop"],
                                         kw["steps"], kw["hidden"])
    want_params, want_stats = es.run_fused(params, kw["generations"])
    assert not torch.equal(want_params, params)
    for out in got.values():
        assert out["spread"] == 0.0
        assert torch.equal(out["params"], want_params)
        assert torch.equal(out["stats"], want_stats)


@pytest.fixture
def world_of_one():
    """A gloo group of this process alone, torn down after the test."""
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_process_mesh_of_one_process(world_of_one):
    """A process mesh of one process: its collectives are identities,
    the ES step and ``run_fused`` equal the 1-rank mesh's exactly, and
    what needs every rank in one process raises."""
    from fiber_tpu_torch.ops import collectives

    mesh = make_mesh("cpu", group=world_of_one)
    assert (mesh.n_dev, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    assert hash(mesh) == hash(mesh) and mesh == mesh
    x = torch.arange(4.0)
    assert torch.equal(collectives.psum(x, mesh), x)
    assert torch.equal(collectives.pmean([x], mesh), x)
    assert torch.equal(collectives.all_gather(x, mesh), x[None])
    with pytest.raises(ValueError):
        collectives.psum([x, x], mesh)
    with pytest.raises(NotImplementedError):
        collectives.ppermute([x], mesh)
    with pytest.raises(NotImplementedError):
        mesh.sub_meshes("pool")
    with pytest.raises(ValueError):
        make_mesh("cpu", n=2, group=world_of_one)
    es, params = pod_es_ring.flagship_es(mesh, 16, 20, (8,))
    one, _ = pod_es_ring.flagship_es(make_mesh("cpu"), 16, 20, (8,))
    for run in (lambda e: e.step(params), lambda e: e.run_fused(params, 2)):
        got, want = run(es), run(one)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(es.last_fitness, one.last_fitness)
