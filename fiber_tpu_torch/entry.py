"""Entry points of the flagship workload: MLP-policy CartPole under
OpenAI-ES.

Counterpart of ``entry()`` in the JAX package's ``__graft_entry__.py``
(a batch of policy evaluations, the unit of work the device plane runs)
plus one-device ES generations, as its multi-chip dry run takes.
"""

from __future__ import annotations

import torch

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops.es import EvolutionStrategy

HIDDEN = (32, 32)


def flagship_policy() -> MLPPolicy:
    return MLPPolicy(CartPole.obs_dim, CartPole.act_dim, hidden=HIDDEN)


def entry(device=None, pop: int = 8, max_steps: int = 100, seed: int = 0):
    """Returns ``(fn, example_args)``: ``fn(params_batch (pop, dim),
    states (pop, 4)) -> (pop,)`` returns of a batch of policies, with
    ``pop`` copies of one initial policy and initial states drawn from
    ``seed`` on ``device``."""
    dev = resolve_device(device)
    policy = flagship_policy()

    def eval_batch(params_batch, states):
        return CartPole.rollout(policy.act, params_batch, states,
                                max_steps=max_steps)

    base = policy.init(torch.Generator().manual_seed(seed), device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    states = CartPole.reset(pop, gen)
    return eval_batch, (base.expand(pop, -1).contiguous(), states)


def run_es(device=None, pop: int = 4096, max_steps: int = 500,
           generations: int = 1, sigma: float = 0.1, lr: float = 0.03,
           seed: int = 0):
    """``generations`` ES steps of the flagship configuration (defaults:
    ``bench.py``'s pop 4096, 500-step episodes, sigma 0.1, lr 0.03).
    Returns ``(params, stats)`` with stats (generations, 3)."""
    dev = resolve_device(device)
    policy = flagship_policy()
    es = EvolutionStrategy(
        lambda thetas, states: CartPole.rollout(
            policy.act, thetas, states, max_steps=max_steps),
        CartPole.reset, dim=policy.dim, pop_size=pop, sigma=sigma, lr=lr,
        device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))
    params = policy.init(torch.Generator().manual_seed(seed), device=dev)
    stats = []
    for _ in range(generations):
        params, s = es.step(params)
        stats.append(s)
    return params, torch.stack(stats)
