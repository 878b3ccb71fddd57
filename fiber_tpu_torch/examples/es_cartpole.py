"""OpenAI-ES on CartPole, fully on the device: the flagship workload.
The whole generation (perturb, roll out the population, rank, update)
runs on the card, and ``--fused`` replays it as a captured CUDA graph.

Counterpart of the JAX package's ``examples/es_cartpole.py``, with its
flags, its defaults and its output lines. Params are drawn from seed 0
and every generation's noise and start states from one generator of
seed 1.

Run:  python -m fiber_tpu_torch.examples.es_cartpole [--pop 1024]
          [--gens 50] [--algo es|pgpe|cma|fullcma] [--fused]
          [--device cpu]
"""

import argparse
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.es_cartpole")
    parser.add_argument("--pop", type=int, default=1024)
    parser.add_argument("--gens", type=int, default=50)
    parser.add_argument("--steps", type=int, default=500)
    parser.add_argument("--hidden", type=int, default=32)
    parser.add_argument("--optimizer", default="sgd",
                        choices=("sgd", "adam"))
    parser.add_argument("--algo", default="es",
                        choices=("es", "pgpe", "cma", "fullcma"),
                        help="algorithm family: OpenAI-ES (default), "
                             "PGPE, sep-CMA-ES, or full-covariance "
                             "CMA-ES")
    parser.add_argument("--fused", action="store_true",
                        help="run generations as CUDA-graph replays")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.algo != "es" and args.optimizer != "sgd":
        parser.error("--optimizer applies only to --algo es")
    return args


def run_family(algo, policy, eval_fn, pop, gens, fused, device):
    """``gens`` generations of PGPE, SepCMAES or CMAES from the policy's
    seed-0 params, as one ``run_fused`` or as eager steps. Returns
    ``(opt, history of (mean, max) a generation, seconds)``."""
    import torch

    from fiber_tpu_torch.device import synchronize
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.ops import CMAES, PGPE, SepCMAES

    cls = {"pgpe": PGPE, "cma": SepCMAES, "fullcma": CMAES}[algo]
    opt = cls(eval_fn, CartPole.reset, dim=policy.dim, pop_size=pop,
              device=device,
              generator=torch.Generator(device=device).manual_seed(1))
    state = opt.init_state(policy.init(torch.Generator().manual_seed(0),
                                       device=device))
    t0 = time.time()
    if fused:
        state, stats = opt.run_fused(state, gens)
    else:
        state, hist = opt.run(state, gens)
        stats = torch.stack(hist)
    history = stats[:, :2].tolist()
    synchronize(device)
    return opt, history, time.time() - t0


def run_es(policy, eval_fn, pop, gens, optimizer, fused, device):
    """``gens`` OpenAI-ES generations (sigma 0.1, lr 0.03) from the
    policy's seed-0 params: with ``fused``, replays in chunks of ``gens
    // 10`` generations, one history row a chunk (two chunk lengths at
    most, so at most two captures); else eager steps, one row every
    ``gens // 10``. Returns ``(es, params, history of (gen, mean, max),
    seconds)``."""
    import torch

    from fiber_tpu_torch.device import synchronize
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.ops import EvolutionStrategy

    es = EvolutionStrategy(eval_fn, CartPole.reset, dim=policy.dim,
                           pop_size=pop, sigma=0.1, lr=0.03,
                           optimizer=optimizer, device=device,
                           generator=torch.Generator(
                               device=device).manual_seed(1))
    params = policy.init(torch.Generator().manual_seed(0), device=device)
    t0 = time.time()
    if fused:
        chunk = max(1, gens // 10)
        history = []
        done = 0
        while done < gens:
            n = min(chunk, gens - done)
            params, stats_seq = es.run_fused(params, n)
            last = stats_seq[-1].tolist()
            done += n
            history.append((done - 1, last[0], last[1]))
    else:
        params, history = es.run(params, gens,
                                 log_every=max(1, gens // 10))
    synchronize(device)
    return es, params, history, time.time() - t0


def main(argv=None) -> int:
    args = parse_args(argv)

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.envs import CartPole
    from fiber_tpu_torch.models.policies import MLPPolicy

    dev = resolve_device(args.device)
    policy = MLPPolicy(CartPole.obs_dim, CartPole.act_dim,
                       hidden=(args.hidden, args.hidden))

    def eval_fn(thetas, states):
        return CartPole.rollout(policy.act, thetas, states,
                                max_steps=args.steps)

    if args.algo != "es":
        opt, hist, elapsed = run_family(args.algo, policy, eval_fn, args.pop,
                                        args.gens, args.fused, dev)
        every = max(1, args.gens // 10)
        for g, (mean, best) in enumerate(hist):
            if g % every == 0 or g == args.gens - 1:
                print(f"gen {g:4d}  mean {mean:8.2f}  best {best:8.2f}")
        evals = opt.pop_size * args.gens
        print(f"{evals} policy evals in {elapsed:.1f}s "
              f"= {evals / elapsed:,.0f} evals/s [{args.algo}]")
        return 0

    es, _, history, elapsed = run_es(policy, eval_fn, args.pop, args.gens,
                                     args.optimizer, args.fused, dev)
    for gen, mean, best in history:
        print(f"gen {gen:4d}  mean {mean:8.2f}  best {best:8.2f}")
    evals = es.pop_size * args.gens
    print(f"{evals} policy evals in {elapsed:.1f}s "
          f"= {evals / elapsed:,.0f} evals/s "
          f"({evals * args.steps / elapsed:,.0f} env-steps/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
