"""Entry points of the device plane's two workloads.

MLP-policy CartPole under OpenAI-ES, the flagship: counterpart of
``entry()`` in the JAX package's ``__graft_entry__.py`` (a batch of
policy evaluations, the unit of work the device plane runs) plus
one-device ES generations, as its multi-chip dry run takes, and
``bench.py``'s other ES modes (``--biped``, ``--pixels``) through
:func:`run_es`'s ``env``. POET: :func:`run_poet` is ``bench.py --poet``
(``_poet_bench``).

:func:`run_es` and :func:`run_poet` report ``bench.py``'s rate fields
(:func:`throughput`: evals/s, model FLOP/s and MFU).

TinyLM training: :func:`train_lm` is ``bench.py --lm``
(``_lm_bench``): its ring leg over a mesh, and the single-device flash
leg it is compared with.
"""

from __future__ import annotations

import time

import torch

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.models.envs import (
    CartPole,
    ParamBipedWalker,
    ParamCartPole,
    PixelChase,
)
from fiber_tpu_torch.models.policies import ConvPolicy, MLPPolicy
from fiber_tpu_torch.models.transformer import TinyLM, adamw, make_train_step
from fiber_tpu_torch.ops.es import EvolutionStrategy
from fiber_tpu_torch.ops.poet import POET
from fiber_tpu_torch.parallel.mesh import make_mesh
from fiber_tpu_torch.utils import flops as flopsmod

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


#: ``bench.py``'s per-env ES defaults: (pop, max_steps)
ES_ENV_DEFAULTS = {"cartpole": (4096, 500), "biped": (4096, 400),
                   "pixels": (1024, PixelChase.max_steps)}


def make_es(env: str = "cartpole", device=None, pop=None, max_steps=None,
            sigma: float = 0.1, lr: float = 0.03, seed: int = 0):
    """The strategy and initial params that :func:`run_es` runs:
    ``bench.py``'s ES on ``env`` (``"cartpole"``: the flagship, MLP (32,
    32); ``"biped"``: ``ParamBipedWalker`` on its flat ``DEFAULT``
    course, MLP (32, 32); ``"pixels"``: ``PixelChase`` with
    ``ConvPolicy((24, 24, 1), 5)``), with ``pop`` and ``max_steps`` from
    :data:`ES_ENV_DEFAULTS` when not given; params from ``seed``, noise
    and initial states from ``seed + 1``. Returns ``(es, params)``."""
    return _es_setup(env, device, pop, max_steps, sigma, lr, seed)[:2]


def _es_setup(env, device, pop, max_steps, sigma, lr, seed):
    """:func:`make_es`'s ``(es, params)`` and the policy, the env's name
    and the episode length that its FLOP count needs."""
    if env not in ES_ENV_DEFAULTS:
        raise ValueError(f"unknown env {env!r}: one of "
                         f"{sorted(ES_ENV_DEFAULTS)}")
    dev = resolve_device(device)
    pop = pop or ES_ENV_DEFAULTS[env][0]
    steps = max_steps or ES_ENV_DEFAULTS[env][1]
    if env == "cartpole":
        policy, env_cls = flagship_policy(), CartPole

        def eval_fn(thetas, states):
            return CartPole.rollout(policy.act, thetas, states,
                                    max_steps=steps)
    elif env == "biped":
        env_cls = ParamBipedWalker
        policy = MLPPolicy(env_cls.obs_dim, env_cls.act_dim, hidden=HIDDEN)
        course = torch.tensor(env_cls.DEFAULT, device=dev)

        def eval_fn(thetas, states):
            return ParamBipedWalker.rollout_p(policy.act, course, thetas,
                                              states, max_steps=steps)
    else:
        env_cls = PixelChase
        policy = ConvPolicy(env_cls.obs_shape, env_cls.act_dim)

        def eval_fn(thetas, states):
            return PixelChase.rollout(policy.act, thetas, states,
                                      max_steps=steps)
    es = EvolutionStrategy(
        eval_fn, env_cls.reset, dim=policy.dim, pop_size=pop, sigma=sigma,
        lr=lr, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed + 1))
    params = policy.init(torch.Generator().manual_seed(seed), device=dev)
    return es, params, policy, env_cls.__name__, steps


def throughput(evals: int, flops: float, seconds: float, devices) -> dict:
    """``bench.py``'s rate fields for ``evals`` evaluations of ``flops``
    model operations in ``seconds`` on ``devices`` (a mesh's ranks):
    evals/s, model FLOP/s, MFU against the cards' bf16 peak (None on the
    CPU), the device kind and the peak row it resolved to."""
    model_fps = flops / seconds
    return {"seconds": seconds, "evals_per_sec": evals / seconds,
            "model_flops_per_sec": model_fps,
            "mfu": flopsmod.mfu(model_fps, devices),
            **flopsmod.peak_report(devices)}


def run_es(device=None, pop=None, max_steps=None, generations: int = 1,
           sigma: float = 0.1, lr: float = 0.03, seed: int = 0,
           env: str = "cartpole"):
    """``generations`` ES steps of ``bench.py``'s ES on ``env`` (see
    :func:`make_es`; by default the flagship at pop 4096 and 500-step
    episodes), run and timed as ``bench.py`` runs them: a warm-up
    ``EvolutionStrategy.run_fused`` of ``generations`` (on CUDA it
    captures one generation), then a timed one of ``generations`` more
    from its params (replayed ``generations`` times). Returns ``(params,
    stats, perf)``: the timed run's params and (generations, 3) stats,
    and its :func:`throughput` with ``es_flops_per_gen`` a
    generation."""
    es, params, policy, env_name, steps = _es_setup(
        env, device, pop, max_steps, sigma, lr, seed)
    params, stats = es.run_fused(params, generations)
    _sync(es.device)
    t0 = time.perf_counter()
    params, stats = es.run_fused(params, generations)
    _sync(es.device)
    secs = time.perf_counter() - t0
    gen_flops = flopsmod.es_flops_per_gen(policy, env_name, steps,
                                          es.pop_size, policy.dim)
    return params, stats, throughput(es.pop_size * generations,
                                     gen_flops * generations, secs,
                                     es.mesh.devices)


def make_poet(device=None, pop: int = 4096, max_steps: int = 500,
              max_pairs: int = 6, seed: int = 0, ranks: int = 1) -> POET:
    """``bench.py --poet``'s POET: ``ParamCartPole`` with an MLP (16,),
    sigma 0.1, lr 0.03, its device and pick generators seeded ``seed``,
    every ES generation over a mesh of ``ranks`` ranks on ``device``."""
    dev = resolve_device(device)
    policy = MLPPolicy(ParamCartPole.obs_dim, ParamCartPole.act_dim,
                       hidden=(16,))
    return POET(ParamCartPole, policy, pop_size=pop, max_pairs=max_pairs,
                rollout_steps=max_steps, mesh=make_mesh(dev, n=ranks),
                generator=torch.Generator(device=dev).manual_seed(seed),
                pick_generator=torch.Generator().manual_seed(seed))


def run_poet(device=None, pop: int = 4096, max_steps: int = 500,
             iterations: int = 10, es_steps: int = 4, max_pairs: int = 6,
             seed: int = 0, ranks: int = 1):
    """``bench.py --poet``: :func:`make_poet`'s POET run for
    ``iterations`` rounds of ``es_steps`` ES generations a pair, timed
    as ``bench.py`` times it (no warm-up). Returns ``(history, evals,
    perf)``, the evaluations counted as ``bench.py`` counts them
    (``pairs * pop * es_steps + transfer_evals`` a round) and ``perf``
    their :func:`throughput` at ``rollout_flops_per_eval`` each."""
    poet = make_poet(device, pop, max_steps, max_pairs, seed, ranks)
    _sync(poet.device)
    t0 = time.perf_counter()
    history = poet.run(iterations, es_steps=es_steps)
    _sync(poet.device)
    secs = time.perf_counter() - t0
    evals = sum(h["pairs"] * poet.pop_size * es_steps + h["transfer_evals"]
                for h in history)
    flops = evals * flopsmod.rollout_flops_per_eval(
        poet.policy, "ParamCartPole", max_steps)
    return history, evals, throughput(evals, flops, secs,
                                      poet.mesh.devices)


def train_lm(device=None, seq: int = 16384, steps: int = 5, seed: int = 0,
             attention: str = "flash", ranks: int = 1):
    """``bench.py --lm``: TinyLM (vocab 256, dim 256, 8 heads, 4 layers)
    at ``seq`` tokens on the ``attention`` plane over a mesh of
    ``ranks`` ranks on ``device``, AdamW at lr 1e-3 (optax's defaults,
    see :func:`adamw`), weights from ``seed`` and one batch of tokens
    from ``seed + 1``; one warm-up step, then ``steps`` timed steps on
    that batch. The defaults are the benchmark's single-device flash
    leg; ``attention="ring"`` over the mesh is its headline leg, and
    ``"ulysses"`` and multi-rank ``"flash"`` the other planes. Returns
    ``(losses, seconds)``: the timed steps' losses as a (steps,) f32
    tensor and their wall time, by the host clock around work that ends
    in a device synchronise."""
    dev = resolve_device(device)
    model = TinyLM(**LM_WIDTHS, max_seq=seq, attention=attention,
                   mesh=make_mesh(dev, n=ranks),
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
