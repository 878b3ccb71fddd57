"""Novelty-search ES on the deceptive maze, the domain family these
algorithms were built for.

``DeceptiveMaze``: the goal is directly above the start, behind a wall;
the fitness gradient presses straight into the wall, and the only way
through is around either end, through states that score worse first.
Plain ES converges to the wall and stays there. The NS-ES family
(``NoveltyES``) blends fitness ranks with behavior-novelty ranks
(behavior = final position, scored against a device-resident archive
of everywhere the search has ended before), so the population is pushed
toward places it has not been, around the wall included. Deceptive
domains are scored by the best candidate ever found.

Counterpart of the JAX package's ``examples/novelty_maze.py``, with its
flags, its defaults and its output lines. Params are drawn from seed 0;
the plain ES's draws from a generator of seed 1, each novelty mode's
(its archive's first behavior included) from one of seed 2.

Run:  python -m fiber_tpu_torch.examples.novelty_maze [--pop 256]
          [--gens 30] [--device cpu]
"""

import argparse

#: (reward weight, adaptive, label) of the three novelty modes
MODES = ((0.0, False, "NS-ES   (pure novelty)"),
         (0.5, False, "NSR-ES  (half blend)"),
         (1.0, True, "NSRA-ES (adaptive)"))


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.novelty_maze")
    parser.add_argument("--pop", type=int, default=256)
    parser.add_argument("--gens", type=int, default=30)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def maze_policy():
    from fiber_tpu_torch.models.envs import DeceptiveMaze
    from fiber_tpu_torch.models.policies import MLPPolicy

    return MLPPolicy(DeceptiveMaze.obs_dim, DeceptiveMaze.act_dim,
                     hidden=(16,))


def maze_eval_bc(policy):
    """``eval_fn(thetas, states) -> (negative goal distance, final
    position)``: the novelty and MAP-Elites examples' evaluation."""
    from fiber_tpu_torch.models.envs import DeceptiveMaze

    def eval_bc(thetas, states):
        return DeceptiveMaze.fitness_and_behavior(policy.apply, thetas,
                                                  states)

    return eval_bc


def make_novelty(policy, pop: int, reward_weight: float, adaptive: bool,
                 device=None):
    """The example's NoveltyES (sigma 0.1, lr 0.05, archive 128, k 10,
    weight step 0.1, patience 5) in one mode, its draws from seed 2."""
    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.envs import DeceptiveMaze
    from fiber_tpu_torch.ops import NoveltyES

    dev = resolve_device(device)
    return NoveltyES(maze_eval_bc(policy), DeceptiveMaze.reset,
                     dim=policy.dim, bc_dim=2, pop_size=pop, sigma=0.1,
                     lr=0.05, archive_size=128, k=10,
                     reward_weight=reward_weight, adaptive=adaptive,
                     weight_delta=0.1, patience=5, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))


def best_ever(step, state, gens: int):
    """``gens`` steps; returns (the best population max seen, the last
    state)."""
    best = -float("inf")
    for _ in range(gens):
        state, stats = step(state)
        best = max(best, float(stats[1]))
    return best, state


def run_all(pop: int, gens: int, device=None):
    """Plain ES, then the three novelty modes, from one start. Returns
    ``[(label, best-ever fitness, final reward weight or None)]``."""
    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.envs import DeceptiveMaze
    from fiber_tpu_torch.ops import EvolutionStrategy

    dev = resolve_device(device)
    policy = maze_policy()
    p0 = policy.init(torch.Generator().manual_seed(0), device=dev)

    def fitness_fn(thetas, states):
        return DeceptiveMaze.rollout(policy.apply, thetas, states)

    es = EvolutionStrategy(fitness_fn, DeceptiveMaze.reset, dim=policy.dim,
                           pop_size=pop, sigma=0.1, lr=0.05, device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(1))
    results = [("plain ES", best_ever(es.step, p0, gens)[0], None)]
    for w, adaptive, label in MODES:
        nes = make_novelty(policy, pop, w, adaptive, dev)
        nbest, state = best_ever(nes.step, nes.init_state(p0), gens)
        results.append((label, nbest, float(state.w)))
    return results


def main(argv=None) -> int:
    args = parse_args(argv)
    results = run_all(args.pop, args.gens, args.device)
    print("best-ever candidate fitness (0 = goal reached; the wall")
    print("pins plain ES at -1.0 — it never finds the way around):")
    for label, best, w in results:
        tail = "" if w is None else f"   [final reward weight {w:.2f}]"
        print(f"  {label:24s} {best:8.3f}{tail}")
    print("novelty search done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
