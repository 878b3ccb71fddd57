"""ES over a pool of workers evaluating a pure-Python simulator: the
reference's own workflow, end to end.

The reference's gecco-2020 ES samples perturbations centrally and farms
evaluation through ``fiber.Pool(40).map`` of arbitrary Python (gym envs,
C simulators). This example is that loop on the port: ``AskTellES``
samples and updates on the card, and a ``Pool`` evaluates a hand-written
pure-Python CartPole in worker processes, with no torch in the
evaluation. When the evaluation is a tensor program, use
``EvolutionStrategy`` and keep the whole generation on the card
(``es_cartpole``).

Counterpart of the JAX package's ``examples/es_pool_gym.py``, with its
flags, its defaults and its output lines. Noise comes from a generator
of seed 0.

Run:  python -m fiber_tpu_torch.examples.es_pool_gym [--workers 4]
          [--pop 64] [--gens 10] [--device cpu]
"""

import argparse
import math
import random


def simulate_cartpole(theta) -> float:
    """Pure-Python CartPole with a linear policy, 200 steps from a fixed
    start: the kind of arbitrary host code the reference's pools were
    built to evaluate."""
    rng = random.Random(12345)
    x, v, a, w = [0.02 * (rng.random() - 0.5) for _ in range(4)]
    g, mc, mp_, lp, dt = 9.8, 1.0, 0.1, 0.5, 0.02
    steps = 0
    for _ in range(200):
        obs = (x, v, a, w)
        score = sum(t * o for t, o in zip(theta, obs))
        force = 10.0 if score > 0 else -10.0
        cosa, sina = math.cos(a), math.sin(a)
        tmp = (force + mp_ * lp * w * w * sina) / (mc + mp_)
        aacc = (g * sina - cosa * tmp) / (
            lp * (4.0 / 3.0 - mp_ * cosa * cosa / (mc + mp_)))
        xacc = tmp - mp_ * lp * aacc * cosa / (mc + mp_)
        x, v = x + dt * v, v + dt * xacc
        a, w = a + dt * w, w + dt * aacc
        steps += 1
        if abs(x) > 2.4 or abs(a) > 0.209:
            break
    return float(steps)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.es_pool_gym")
    parser.add_argument("--workers", type=int, default=4)
    parser.add_argument("--pop", type=int, default=64)
    parser.add_argument("--gens", type=int, default=10)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def make_es(pop: int, device=None):
    """The example's ``AskTellES``: dim 4, sigma 0.5, lr 0.3."""
    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.ops import AskTellES

    dev = resolve_device(device)
    return AskTellES(dim=4, pop_size=pop, sigma=0.5, lr=0.3, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(0))


def generation(es, evaluate) -> dict:
    """One ask, ``evaluate`` over the candidates' lists, one tell."""
    return es.tell(evaluate([t.tolist() for t in es.ask()]))


def main(argv=None) -> int:
    args = parse_args(argv)

    import fiber_tpu_torch

    es = make_es(args.pop, args.device)
    with fiber_tpu_torch.Pool(args.workers) as pool:
        for gen in range(args.gens):
            stats = generation(
                es, lambda thetas: pool.map(simulate_cartpole, thetas))
            print(f"gen {gen}: mean {stats['mean_fitness']:6.1f}  "
                  f"max {stats['max_fitness']:6.1f}", flush=True)

    final = simulate_cartpole(es.params.tolist())
    print(f"final policy survives {final:.0f}/200 steps")
    print("pool-evaluated ES done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
