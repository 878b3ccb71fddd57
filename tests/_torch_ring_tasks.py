"""Rank functions that the port's ring tests hand to
``fiber_tpu_torch.parallel.Ring``. Module level, so that rank processes
import them by reference; the module imports neither JAX nor the JAX
package, and torch only where a rank needs it. Those that report take
a managed dict (``results``), bound with ``functools.partial``, and
write their rank's outcome there for the test to compare."""

from __future__ import annotations

import sys

from fiber_tpu_torch.parallel.ring import torch_distributed_initializer


def host_ring_rank(rank, size, results, inputs):
    """Sum and mean of ``inputs[rank]`` over the ring, as numpy and as a
    CPU tensor, and whether torch was loaded before the tensor part."""
    import numpy as np

    from fiber_tpu_torch.parallel.ring import current_ring

    ring = current_ring()
    torch_before = "torch" in sys.modules
    arr = np.asarray(inputs[rank])
    out = {"torch_before": torch_before,
           "sum": ring.allreduce(arr), "mean": ring.allreduce(arr, "mean")}
    import torch

    t = torch.from_numpy(arr.copy())
    out["sum_t"] = ring.allreduce(t)
    out["mean_t"] = ring.allreduce(t, op="mean")
    out["broadcast_t"] = ring.broadcast(t * (rank + 1), root=1)
    ring.barrier()
    results[rank] = out
    ring.close()


def sgd_rank(rank, size):
    """Mini data-parallel SGD: per-rank gradient, ring-averaged update
    (``tests/targets.py``'s ``ring_sgd_step`` on the port's ring)."""
    import numpy as np

    from fiber_tpu_torch.parallel.ring import current_ring

    ring = current_ring()
    w = np.zeros(8, dtype=np.float32)
    for _ in range(3):
        grad = np.full(8, float(rank + 1), dtype=np.float32)
        avg = ring.allreduce(grad, op="mean")
        w -= 0.1 * avg
    expected = -0.3 * (size + 1) / 2
    if not np.allclose(w, expected):
        raise AssertionError((rank, w[0], expected))
    ring.close()


def dist_rank(rank, size, results):
    """After ``torch_distributed_initializer``: a raw ``all_reduce``, and
    ``psum``/``pmean``/``all_gather`` over the process mesh."""
    import torch
    import torch.distributed as dist

    from fiber_tpu_torch.ops import collectives
    from fiber_tpu_torch.parallel.mesh import make_mesh

    try:
        x = torch.full((5,), float(rank + 1))
        dist.all_reduce(x)
        mesh = make_mesh("cpu", group=dist.group.WORLD)
        own = torch.arange(3.0) + 10 * rank
        results[rank] = {
            "world": dist.get_world_size(), "rank": dist.get_rank(),
            "backend": dist.get_backend(), "all_reduce": x,
            "mesh": (mesh.n_dev, mesh.rank),
            "psum": collectives.psum(own, mesh),
            "pmean": collectives.pmean([own], mesh),
            "all_gather": collectives.all_gather(own, mesh)}
    finally:
        dist.destroy_process_group()



#: whether this rank's process took the port rank 0 advertised for its
#: TCP store (set by squat_then_join)
PORT_TAKEN = None


def squat_then_join(rank, size, addrs):
    """An initializer that first tries to take the port rank 0 advertised
    for its TCP store, as any other process of the machine might between
    the rendezvous and the store's start; it keeps the port if it gets
    it, records whether it did in PORT_TAKEN, then joins the gloo group
    through ``torch_distributed_initializer``."""
    import socket

    global PORT_TAKEN
    squatter = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    try:
        squatter.bind(("", addrs[0][1]))
        squatter.listen(1)
        PORT_TAKEN = True
    except OSError:
        squatter.close()
        PORT_TAKEN = False
    try:
        torch_distributed_initializer(rank, size, addrs)
    finally:
        if PORT_TAKEN:
            squatter.close()


# the rendezvous treats it as it treats the initializer it wraps
squat_then_join._prebind = getattr(torch_distributed_initializer,
                                   "_prebind", False)


def squatted_dist_rank(rank, size, results):
    """``dist_rank`` after ``squat_then_join``, with PORT_TAKEN."""
    dist_rank(rank, size, results)
    results[rank] = dict(results[rank], port_taken=PORT_TAKEN)
