"""POET on parameterized physics: environment and agent co-evolution with
the whole data path on the device.

Counterpart of the JAX package's ``examples/poet_cartpole.py``, with
its flags, its minimal-criterion defaults and its output lines. The
POET's device generator and its parent picks are seeded 0.

Run:  python -m fiber_tpu_torch.examples.poet_cartpole [--iters 10]
          [--env cartpole|hill|biped] [--device cpu]
"""

import argparse
import sys
import time

ES_STEPS = 4


def mc_defaults(env: str, steps: int, mc_low=None, mc_high=None):
    """The minimal criterion's ``(low, high)``: walker fitness is metres,
    not survival steps, so both bounds need distance-scale defaults
    there. CartPole: low 10.0, high None (POET's ``0.9 * steps``); the
    walkers: low 0.5, high about 90% of a good walker's reach
    (``0.15 * steps`` on the hill, ``0.045 * steps`` for the biped)."""
    if mc_low is None:
        mc_low = 10.0 if env == "cartpole" else 0.5
    if mc_high is None and env != "cartpole":
        per_step = 0.15 if env == "hill" else 0.045
        mc_high = per_step * steps
    return mc_low, mc_high


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.poet_cartpole")
    parser.add_argument("--iters", type=int, default=10)
    parser.add_argument("--pop", type=int, default=256)
    parser.add_argument("--pairs", type=int, default=6)
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--env", default="cartpole",
                        choices=("cartpole", "hill", "biped"),
                        help="co-evolution domain (biped = the published "
                             "POET walker-on-obstacle-course shape)")
    parser.add_argument("--mc-low", type=float, default=None,
                        help="minimal-criterion floor for admitting new "
                             "envs (units = the domain's fitness: "
                             "survival steps for cartpole, metres for "
                             "the walkers; default 10.0, walkers 0.5)")
    parser.add_argument("--mc-high", type=float, default=None,
                        help="minimal-criterion ceiling (reject envs the "
                             "incumbent already solves this well); "
                             "cartpole defaults to 0.9*steps, walkers "
                             "to a distance matched to their speed "
                             "scale")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    args.mc_low, args.mc_high = mc_defaults(args.env, args.steps,
                                            args.mc_low, args.mc_high)
    return args


def make_poet(env, pop, pairs, steps, mc_low, mc_high, device=None):
    """The example's POET: an MLP (16,) on ``env``'s parameterized
    domain."""
    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.envs import (
        ParamBipedWalker,
        ParamCartPole,
        ParamHillWalker,
    )
    from fiber_tpu_torch.models.policies import MLPPolicy
    from fiber_tpu_torch.ops.poet import POET

    dev = resolve_device(device)
    env_cls = {"cartpole": ParamCartPole, "hill": ParamHillWalker,
               "biped": ParamBipedWalker}[env]
    policy = MLPPolicy(env_cls.obs_dim, env_cls.act_dim, hidden=(16,))
    return POET(env_cls, policy, pop_size=pop, max_pairs=pairs,
                rollout_steps=steps, mc_low=mc_low, mc_high=mc_high,
                device=dev, generator=torch.Generator(device=dev).manual_seed(0),
                pick_generator=torch.Generator().manual_seed(0))


def main(argv=None) -> int:
    args = parse_args(argv)
    poet = make_poet(args.env, args.pop, args.pairs, args.steps, args.mc_low,
                     args.mc_high, args.device)
    t0 = time.time()
    history = poet.run(args.iters, es_steps=ES_STEPS, log=print)
    elapsed = time.time() - t0
    final = history[-1]
    total_evals = sum(h["pairs"] * poet.pop_size * ES_STEPS for h in history)
    print(
        f"\n{final['pairs']} co-evolved (env, agent) pairs; final mean "
        f"fitness {final['mean_fitness']:.1f}/{args.steps}; "
        f"~{total_evals:,} policy evals in {elapsed:.1f}s "
        f"({total_evals / elapsed:,.0f} evals/s)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
