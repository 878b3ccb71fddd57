"""The ES flagship across Ring processes: ``Ring`` rank processes joined
by ``torch_distributed_initializer`` into one ``torch.distributed``
group (gloo), running one ``EvolutionStrategy`` over the process mesh
that spans them.

Counterpart of the JAX package's ``examples/pod_es_ring.py``, whose
ranks join one ``jax.distributed`` runtime and run a fused ES over the
global mesh. Every rank draws the whole generation from a generator of
the same seed, rolls out its own members, and gathers the fitness and
sums the gradient across the processes, so its params equal the
single-process mesh's of as many ranks. With ``--sim N`` the ranks are
jobs of N simulated cluster hosts (local host agents of the ``tpu``
backend, ``sim:N``), as on a real cluster; the run then prints the
spread of the ranks' params, which must be 0.

Run:  python -m fiber_tpu_torch.examples.pod_es_ring [--size 2]
          [--sim N] [--device cpu]
"""

import argparse
import contextlib
import functools
import os
import sys

from fiber_tpu_torch.entry import flagship_es


def params_spread(params, mesh) -> float:
    """The max minus the min over the ranks of a digest of ``params``
    (``sum(p_i * (i + 1))``): 0 when every process holds the same
    vector."""
    import torch

    from fiber_tpu_torch.ops import collectives

    weights = torch.arange(1, params.numel() + 1, device=params.device,
                           dtype=params.dtype)
    digests = collectives.all_gather((params.reshape(-1) * weights).sum(),
                                     mesh)
    return float(digests.max() - digests.min())


def train_rank(rank, size, pop=None, steps=100, hidden=(16,),
               generations=5, device=None, results=None):
    """Runs on every rank after the initializer joined them: one ES
    over the process mesh. ``pop`` defaults to 8 members a rank;
    ``results``, a managed dict, receives this rank's params, stats and
    the ranks' params spread."""
    import torch.distributed as dist

    from fiber_tpu_torch.parallel.mesh import make_mesh

    try:
        mesh = make_mesh(device, group=dist.group.WORLD)
        if mesh.n_dev != size:
            raise RuntimeError(f"the group has {mesh.n_dev} ranks, the "
                               f"ring {size}")
        es, params = flagship_es(mesh, pop or 8 * size, steps, hidden)
        params, stats = es.run_fused(params, generations)
        spread = params_spread(params, mesh)
        if rank == 0:
            for g, (mean_f, max_f, _) in enumerate(stats.tolist()):
                print(f"gen {g}: mean fitness {mean_f:8.2f}  "
                      f"max {max_f:8.2f}", flush=True)
        if results is not None:
            results[rank] = {"params": params.cpu(), "stats": stats.cpu(),
                             "spread": spread}
        if spread != 0.0:
            raise RuntimeError(f"rank {rank}: params differ across the "
                               f"ranks (digest spread {spread})")
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def sim_cluster(n: int):
    """Within it, processes start as jobs of ``n`` local host agents
    (the ``tpu`` backend on ``sim:n``); on the way out the agents stop
    and the backend selection is restored."""
    from fiber_tpu_torch import config
    from fiber_tpu_torch.backends import get_backend, reset_backends

    env_backend = os.environ.get("FIBER_BACKEND")
    hosts = config.get().tpu_hosts
    os.environ["FIBER_BACKEND"] = "tpu"   # the environment outranks init
    config.get().update(tpu_hosts=f"sim:{n}")
    reset_backends()
    try:
        backend = get_backend()           # starts the agents
        try:
            yield
        finally:
            backend.shutdown_sim_cluster()
    finally:
        if env_backend is None:
            os.environ.pop("FIBER_BACKEND", None)
        else:
            os.environ["FIBER_BACKEND"] = env_backend
        config.get().update(tpu_hosts=hosts)
        reset_backends()


def run_ring(size: int, device=None) -> dict:
    """The ES over a ``Ring`` of ``size`` rank processes on the current
    backend. Returns ``{rank: {"params", "stats", "spread"}}``."""
    import fiber_tpu_torch
    from fiber_tpu_torch.parallel.ring import (Ring,
                                               torch_distributed_initializer)

    manager = fiber_tpu_torch.Manager()
    try:
        results = manager.dict()
        Ring(size, functools.partial(train_rank, device=device,
                                     results=results),
             initializer=torch_distributed_initializer).run()
        return {r: results[r] for r in range(size)}
    finally:
        manager.shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.pod_es_ring")
    parser.add_argument("--size", type=int, default=2,
                        help="ring size (one rank per cluster host)")
    parser.add_argument("--sim", type=int, default=0, metavar="N",
                        help="run against N simulated localhost agents")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    with sim_cluster(args.sim) if args.sim else contextlib.nullcontext():
        got = run_ring(args.size, args.device)
    print("all ranks joined cleanly")
    spread = max(r["spread"] for r in got.values())
    print(f"params spread over the ranks: {spread}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
