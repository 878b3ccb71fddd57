"""POET with its per-pair ES inner loops farmed over a Pool — the
reference's gecco-2020 architecture (an ES loop over ``fiber.Pool(40)
.map`` on BipedalWalker terrains) on the port: the master owns the POET
state machine (mutation, minimal criterion, novelty archive, transfer)
while each worker process runs an ``EvolutionStrategy`` on the device
for its assigned (env, agent) pair.

Counterpart of the JAX package's ``examples/poet_distributed.py``. It
is a module of the package, so that pool workers import
:func:`es_worker` by reference. Per-pair seeds come from one CPU
``np.random.default_rng``; each worker's generator from its payload's
seed; its device from the payload's ``conf`` (CUDA unless the caller
asks for the CPU).

Run:  python -m fiber_tpu_torch.examples.poet_distributed [--iters 5]
          [--workers 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

# Per-process caches: one EvolutionStrategy (and policy) per conf in each
# worker process, shared across every pair and iteration it serves.
_WORKER_ES = {}


def make_conf(hidden=(16,), pop: int = 256, rollout_steps: int = 200,
              es_steps: int = 3, sigma: float = 0.1, lr: float = 0.03,
              device=None) -> tuple:
    """A payload's ``conf``: (hidden, pop, rollout_steps, es_steps,
    sigma, lr, device), hashable, as the worker caches its strategy on
    it. ``device`` None means CUDA."""
    return (tuple(hidden), int(pop), int(rollout_steps), int(es_steps),
            float(sigma), float(lr), device)


def worker_es(conf):
    """This process's ``(es, policy)`` for ``conf``, made at the first
    call: an ``EvolutionStrategy`` over ``[theta, env params]`` whose
    members are ``ParamCartPole`` episodes under the env vector in their
    tail."""
    entry = _WORKER_ES.get(conf)
    if entry is None:
        from fiber_tpu_torch.models.envs import ParamCartPole
        from fiber_tpu_torch.models.policies import MLPPolicy
        from fiber_tpu_torch.ops.es import EvolutionStrategy

        hidden, pop, rollout_steps, _, sigma, lr, device = conf
        policy = MLPPolicy(ParamCartPole.obs_dim, ParamCartPole.act_dim,
                           hidden=hidden)
        env_dim = len(ParamCartPole.DEFAULT)

        def eval_fn(thetas, states):
            return ParamCartPole.rollout_p(
                policy.act, thetas[:, policy.dim:], thetas[:, :policy.dim],
                states, max_steps=rollout_steps)

        es = EvolutionStrategy(eval_fn, ParamCartPole.reset,
                               dim=policy.dim + env_dim, pop_size=pop,
                               sigma=sigma, lr=lr, device=device)
        entry = _WORKER_ES[conf] = (es, policy)
    return entry


def es_worker(payload):
    """Run ``es_steps`` ES generations for one (env, agent) pair.

    ``payload`` is plain picklable data: (theta, env_params, seed, conf)
    with ``conf`` from :func:`make_conf`. Returns (new_theta ndarray,
    fitness float): the last generation's mean fitness.
    """
    import torch

    theta, env_params, seed, conf = payload
    es, policy = worker_es(conf)
    es.generator.manual_seed(int(seed))
    env = torch.as_tensor(env_params, dtype=torch.float32, device=es.device)
    combined = torch.cat([
        torch.as_tensor(theta, dtype=torch.float32, device=es.device), env])
    stats = None
    for _ in range(conf[3]):
        combined, stats = es.step(combined)
        # The env tail is part of the ES vector for a shared strategy but
        # must not drift — the pair's environment is fixed.
        combined = torch.cat([combined[:policy.dim], env])
    return combined[:policy.dim].cpu().numpy(), float(stats[0])


def run(iterations: int = 5, workers: int = 2, pop: int = 256,
        pairs: int = 4, steps: int = 200, es_steps: int = 3, device=None,
        seed: int = 0, in_process: bool = False, log=None):
    """The master loop: every iteration optimises every active pair in
    parallel across ``Pool(workers)`` (or, with ``in_process``, one after
    another in this process, through the same :func:`es_worker`), then
    transfers and spawns envs on the master's ``POET``. Returns
    ``(history, total_evals, seconds, poet)``: one record an iteration
    (``pairs``, ``fitness``, ``transfers``, ``spawned``), the
    evaluations counted as the JAX package's example counts them
    (pairs x pop x ES steps, and the transfers' proposal evaluations),
    the loop's seconds, and the master's ``POET``."""
    import numpy as np
    import torch

    import fiber_tpu_torch
    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.envs import ParamCartPole
    from fiber_tpu_torch.models.policies import MLPPolicy
    from fiber_tpu_torch.ops.poet import POET

    dev = resolve_device(device)
    hidden = (16,)
    policy = MLPPolicy(ParamCartPole.obs_dim, ParamCartPole.act_dim,
                       hidden=hidden)
    sigma, lr = 0.1, 0.03   # POET's defaults, which the workers' ES share
    poet = POET(ParamCartPole, policy, pop_size=pop, sigma=sigma, lr=lr,
                max_pairs=pairs, rollout_steps=steps, device=dev,
                generator=torch.Generator(device=dev).manual_seed(seed),
                pick_generator=torch.Generator().manual_seed(seed))
    conf = make_conf(hidden, poet.pop_size, steps, es_steps, sigma, lr,
                     None if dev.type == "cuda" else dev.type)
    seeds = np.random.default_rng(seed)
    history, total_evals = [], 0
    t0 = time.perf_counter()
    pool = None if in_process else fiber_tpu_torch.Pool(workers)
    try:
        for it in range(iterations):
            # 1. Optimize every active pair in parallel across the pool
            #    (the reference farms exactly this loop over its Pool).
            payloads = [
                (poet.agents[i].cpu().numpy(), poet.envs[i].cpu().numpy(),
                 int(s), conf)
                for i, s in enumerate(seeds.integers(0, 2**31 - 1,
                                                     size=len(poet.envs)))]
            results = (list(map(es_worker, payloads)) if pool is None
                       else pool.map(es_worker, payloads, chunksize=1))
            for i, (theta, _) in enumerate(results):
                poet.agents[i] = torch.as_tensor(theta, device=dev)
            total_evals += len(payloads) * poet.pop_size * es_steps
            record = {"iteration": it, "pairs": len(poet.envs),
                      "fitness": [f for _, f in results]}
            # 2./3. Transfer + env mutation stay on the master (tiny).
            record["transfers"] = poet.transfer()
            total_evals += poet.last_transfer_evals
            record["spawned"] = poet.try_spawn_envs()
            history.append(record)
            if log:
                log(f"iter {it}: pairs={record['pairs']} fitness="
                    f"{[round(f, 1) for f in record['fitness']]} "
                    f"transfers={record['transfers']} "
                    f"spawned={record['spawned']}")
    finally:
        if pool is not None:
            pool.close()
            pool.join()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return history, total_evals, time.perf_counter() - t0, poet


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--pop", type=int, default=256)
    parser.add_argument("--pairs", type=int, default=4)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--es-steps", type=int, default=3)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args()

    history, total_evals, elapsed, poet = run(
        args.iters, args.workers, args.pop, args.pairs, args.steps,
        args.es_steps, args.device, log=lambda s: print(s, flush=True))
    print(f"\n{len(poet.envs)} pairs co-evolved; ~{total_evals:,} policy "
          f"evals in {elapsed:.1f}s ({total_evals / elapsed:,.0f} evals/s) "
          f"across {args.workers} pool workers")
    return 0


if __name__ == "__main__":
    sys.exit(main())
