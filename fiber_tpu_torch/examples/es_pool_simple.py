"""Parallel OpenAI-ES over Pool.map — the host-path half of
docs/tutorials/01-parallel-es.md (reference: the GECCO-2020 tutorial's
ES loop, examples/gecco-2020/es.py — a fiber.Pool(40).map loop over a
numpy objective).

Finds a hidden 3-vector by fitness alone. Workers are idempotent (all
inputs ride in the task argument), so the resilient pool can resubmit
them safely on worker death.

Run:  python -m fiber_tpu_torch.examples.es_pool_simple [--workers 8] [--iters 200]
      FIBER_BACKEND=tpu FIBER_TPU_HOSTS=sim:2 python -m fiber_tpu_torch.examples.es_pool_simple

The JAX package's ``examples/es_pool_simple.py`` with the package renamed
(``tests/test_torch_examples.py`` holds it to the original); it
runs on the host only.
"""


import argparse

import numpy as np

SOLUTION = np.array([5.0, -5.0, 1.5])


def fitness(theta):
    return -np.sum(np.square(theta - SOLUTION))


def worker(args):
    theta, sigma, seed = args
    rng = np.random.default_rng(seed)
    epsilon = rng.standard_normal(theta.shape[0])
    return fitness(theta + sigma * epsilon), epsilon


def es(theta0, pop, sigma, alpha, iterations, pool):
    theta = theta0
    for t in range(iterations):
        jobs = [(theta, sigma, t * pop + i) for i in range(pop)]
        returns = pool.map(worker, jobs)
        rewards = np.array([r for r, _ in returns])
        epsilons = np.stack([e for _, e in returns])
        normalized = (rewards - rewards.mean()) / (rewards.std() + 1e-8)
        theta = theta + alpha / (pop * sigma) * normalized @ epsilons
        if t % 20 == 0:
            print(f"iter {t:4d} fitness {fitness(theta):10.4f} theta {theta}")
    return theta


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", type=int, default=4,
                        help="pool processes (tasks fan out over these)")
    parser.add_argument("--pop", type=int, default=40,
                        help="candidates per iteration (the GECCO "
                             "tutorial used 40 = one per worker; they "
                             "need not match)")
    parser.add_argument("--iters", type=int, default=200)
    parser.add_argument("--sigma", type=float, default=0.1)
    parser.add_argument("--alpha", type=float, default=0.05)
    args = parser.parse_args()

    import fiber_tpu_torch

    theta0 = np.random.default_rng(0).standard_normal(3)
    with fiber_tpu_torch.Pool(args.workers) as pool:
        theta = es(theta0, args.pop, args.sigma, args.alpha,
                   args.iters, pool)
    err = float(np.linalg.norm(theta - SOLUTION))
    print(f"result {theta}  (|error| = {err:.3f})")
    return 0 if err < 0.5 else 1


if __name__ == "__main__":
    raise SystemExit(main())
