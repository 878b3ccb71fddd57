"""MAP-Elites illuminating the deceptive maze.

Quality-diversity's answer to deception: instead of fighting the
misleading fitness gradient (the novelty-search story,
``novelty_maze``), MAP-Elites grids the behavior space (final positions)
and keeps the best policy for every cell it ever reaches. Coverage
spreads outward cell by cell, around the wall as a side effect, and
"solve the maze" falls out as the elite of the goal's cell. Parent
selection, perturbation, evaluation and insertion run on the card.

Counterpart of the JAX package's ``examples/map_elites_maze.py``, with
its flags, its defaults and its output lines. Params are drawn from
seed 0, every other draw from one generator of seed 1.

Run:  python -m fiber_tpu_torch.examples.map_elites_maze [--gens 60]
          [--batch 256] [--cells 12] [--device cpu]
"""

import argparse

from fiber_tpu_torch.examples.novelty_maze import maze_eval_bc, maze_policy


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.map_elites_maze")
    parser.add_argument("--gens", type=int, default=60)
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--cells", type=int, default=12)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def make_map_elites(policy, batch: int, cells: int, device=None):
    """The example's MAPElites: ``cells`` x ``cells`` over [-4, 4]^2,
    ``batch`` children a generation, sigma 0.2, draws from seed 1."""
    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.envs import DeceptiveMaze
    from fiber_tpu_torch.ops import MAPElites

    dev = resolve_device(device)
    return MAPElites(maze_eval_bc(policy), DeceptiveMaze.reset,
                     dim=policy.dim, bc_dim=2, bc_low=(-4.0, -4.0),
                     bc_high=(4.0, 4.0), cells_per_dim=cells,
                     batch_size=batch, sigma=0.2, device=dev,
                     generator=torch.Generator(device=dev).manual_seed(1))


def beyond_wall(state) -> int:
    """Filled cells whose elite ended past the wall (y > 1)."""
    import torch

    return int(((state.behaviors[:, 1] > 1.0)
                & torch.isfinite(state.fitness)).sum())


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    policy = maze_policy()
    me = make_map_elites(policy, args.batch, args.cells, args.device)
    state = me.init_state(policy.init(torch.Generator().manual_seed(0),
                                      device=me.device))
    for gen in range(args.gens):
        state, stats = me.step(state)
        if gen % max(1, args.gens // 6) == 0 or gen == args.gens - 1:
            qd, cov, best = stats[:3].tolist()
            print(f"gen {gen:3d}  coverage {cov:5.1%}  "
                  f"best fitness {best:6.3f}  qd {qd:8.1f}", flush=True)
    # The maze is "solved" if some cell's elite ends within ~0.5 of the
    # goal (fitness > -0.5), past the wall.
    best_fit = float(state.fitness.max())
    print(f"cells illuminated beyond the wall (y > 1): {beyond_wall(state)}")
    print(f"best elite fitness: {best_fit:.3f} "
          f"({'maze solved' if best_fit > -0.5 else 'not solved yet'})")
    print("map-elites done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
