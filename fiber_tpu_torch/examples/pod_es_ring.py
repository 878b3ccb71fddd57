"""The ES flagship across Ring processes: ``Ring`` rank processes joined
by ``torch_distributed_initializer`` into one ``torch.distributed``
group (gloo), running one ``EvolutionStrategy`` over the process mesh
that spans them.

Counterpart of the JAX package's ``examples/pod_es_ring.py``, whose
ranks join one ``jax.distributed`` runtime and run a fused ES over the
global mesh. Every rank draws the whole generation from a generator of
the same seed, rolls out its own members, and gathers the fitness and
sums the gradient across the processes, so its params equal the
single-process mesh's of as many ranks. The JAX example's ``--sim``
(ranks as jobs of simulated cluster hosts) needs the cluster backend,
which the port has not yet.

Run:  python -m fiber_tpu_torch.examples.pod_es_ring [--size 2]
          [--device cpu]
"""

import argparse
import functools
import sys


def flagship_es(mesh, pop: int, steps: int, hidden=(32, 32), seed: int = 0):
    """The CartPole ES as ``entry.run_es`` builds it (sigma 0.1, lr 0.03,
    noise and states from ``seed + 1``, params from ``seed``) with an MLP
    of ``hidden`` over ``mesh``. Returns ``(es, params)``."""
    import torch

    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.models.policies import MLPPolicy
    from fiber_tpu_torch.ops.es import EvolutionStrategy

    policy = MLPPolicy(CartPole.obs_dim, CartPole.act_dim, hidden=hidden)
    es = EvolutionStrategy(
        lambda thetas, states: CartPole.rollout(policy.act, thetas, states,
                                                max_steps=steps),
        CartPole.reset, dim=policy.dim, pop_size=pop, sigma=0.1, lr=0.03,
        mesh=mesh,
        generator=torch.Generator(device=mesh.device).manual_seed(seed + 1))
    return es, policy.init(torch.Generator().manual_seed(seed),
                           device=mesh.device)


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


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--size", type=int, default=2,
                        help="ring size (rank processes)")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    from fiber_tpu_torch.parallel.ring import (Ring,
                                               torch_distributed_initializer)

    Ring(args.size, functools.partial(train_rank, device=args.device),
         initializer=torch_distributed_initializer).run()
    print("all ranks joined cleanly")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
