"""Entry points of the device plane's two workloads.

MLP-policy CartPole under OpenAI-ES, the flagship: counterpart of
``entry()`` in the JAX package's ``__graft_entry__.py`` (a batch of
policy evaluations, the unit of work the device plane runs) plus
one-device ES generations, as its multi-chip dry run takes.

TinyLM training: :func:`train_lm` is the single-device flash leg of
``bench.py --lm`` (``_lm_bench``).
"""

from __future__ import annotations

import time

import torch

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.models.transformer import TinyLM, adamw, make_train_step
from fiber_tpu_torch.ops.es import EvolutionStrategy

HIDDEN = (32, 32)
#: ``bench.py --lm``'s TinyLM widths
LM_WIDTHS = dict(vocab=256, dim=256, heads=8, layers=4)


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


def train_lm(device=None, seq: int = 16384, steps: int = 5, seed: int = 0):
    """The single-device flash leg of ``bench.py --lm``: TinyLM (vocab
    256, dim 256, 8 heads, 4 layers) at ``seq`` tokens with
    ``attention="flash"``, AdamW at lr 1e-3 (optax's defaults, see
    :func:`adamw`), weights from ``seed`` and one batch of tokens from
    ``seed + 1``; one warm-up step, then ``steps`` timed steps on that
    batch. Returns ``(losses, seconds)``: the timed steps' losses as a
    (steps,) f32 tensor and their wall time, by the host clock around
    work that ends in a device synchronise."""
    dev = resolve_device(device)
    model = TinyLM(**LM_WIDTHS, max_seq=seq, attention="flash", device=dev,
                   generator=torch.Generator().manual_seed(seed))
    step = make_train_step(model, adamw(model.parameters(), 1e-3))
    tokens = torch.randint(0, LM_WIDTHS["vocab"], (seq,),
                           generator=torch.Generator().manual_seed(seed + 1))
    tokens = tokens.to(dev)
    step(tokens)
    _sync(dev)
    t0 = time.perf_counter()
    losses = torch.stack([step(tokens) for _ in range(steps)])
    _sync(dev)
    return losses.cpu(), time.perf_counter() - t0


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
