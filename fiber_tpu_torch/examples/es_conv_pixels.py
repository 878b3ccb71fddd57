"""Large-batch ES with a ConvNet policy on pixel observations: the
reference's "Atari ES" configuration shape, with a procedural pixel env
so that the whole rollout (render, conv policy, move) runs on the card.
The policy's convolutions are where the FLOPs are.

Counterpart of the JAX package's ``examples/es_conv_pixels.py``, with
its flags, its defaults and its output lines. Params are drawn from
seed 0, noise and start states from one generator of seed 1.

Run:  python -m fiber_tpu_torch.examples.es_conv_pixels [--pop 256]
          [--gens 20] [--device cpu]
"""

import argparse
import sys
import time


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.examples.es_conv_pixels")
    parser.add_argument("--pop", type=int, default=256)
    parser.add_argument("--gens", type=int, default=20)
    parser.add_argument("--steps", type=int, default=40)
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def make_es(pop: int, steps: int, device=None):
    """The example's ES (sigma 0.05, lr 0.02) over a ``ConvPolicy((24,
    24, 1), 5, channels=(8, 16), hidden=64)`` on ``PixelChase``.
    Returns ``(es, policy, params)``."""
    import torch

    from fiber_tpu_torch.device import resolve_device
    from fiber_tpu_torch.models.envs import PixelChase
    from fiber_tpu_torch.models.policies import ConvPolicy
    from fiber_tpu_torch.ops import EvolutionStrategy

    dev = resolve_device(device)
    policy = ConvPolicy(PixelChase.obs_shape, PixelChase.act_dim,
                        channels=(8, 16), hidden=64)

    def eval_fn(thetas, states):
        return PixelChase.rollout(policy.act, thetas, states,
                                  max_steps=steps)

    es = EvolutionStrategy(eval_fn, PixelChase.reset, dim=policy.dim,
                           pop_size=pop, sigma=0.05, lr=0.02, device=dev,
                           generator=torch.Generator(
                               device=dev).manual_seed(1))
    return es, policy, policy.init(torch.Generator().manual_seed(0),
                                   device=dev)


def main(argv=None) -> int:
    args = parse_args(argv)

    from fiber_tpu_torch.device import synchronize

    es, policy, params = make_es(args.pop, args.steps, args.device)
    print(f"conv policy params: {policy.dim:,}")
    t0 = time.time()
    params, history = es.run(params, generations=args.gens,
                             log_every=max(1, args.gens // 5))
    synchronize(es.device)
    elapsed = time.time() - t0
    for gen, mean, best in history:
        print(f"gen {gen:4d}  mean {mean:8.3f}  best {best:8.3f}")
    evals = es.pop_size * args.gens
    print(f"{evals} conv-policy evals in {elapsed:.1f}s "
          f"= {evals / elapsed:,.0f} evals/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
