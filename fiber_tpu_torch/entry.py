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

The multi-rank dry run and the scaling record: :func:`dryrun_multichip`
and :func:`weak_scaling` are the JAX package's ``__graft_entry__.py``
functions of those names, on the port's mesh, whose ranks all sit on one
device. Run as a module::

    python -m fiber_tpu_torch.entry [N] [--device cpu]
    python -m fiber_tpu_torch.entry --weak-scaling [--json PATH]

With N, the dry run on N ranks; with no argument, :func:`entry`'s batch
and then the dry run on the default mesh's ranks (at most 8);
``--weak-scaling`` prints the scaling record and writes it to ``--json``
when that names a file.
"""

from __future__ import annotations

import time

import torch

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.device import synchronize as _sync
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
from fiber_tpu_torch.parallel.mesh import default_mesh, make_mesh
from fiber_tpu_torch.utils import flops as flopsmod

HIDDEN = (32, 32)
#: ``bench.py --lm``'s TinyLM widths
LM_WIDTHS = dict(vocab=256, dim=256, heads=8, layers=4)


def flagship_policy() -> MLPPolicy:
    return MLPPolicy(CartPole.obs_dim, CartPole.act_dim, hidden=HIDDEN)


def flagship_es(mesh, pop: int, steps: int, hidden=HIDDEN, seed: int = 0):
    """The CartPole ES as :func:`run_es` builds it (sigma 0.1, lr 0.03,
    noise and states from ``seed + 1``, params from ``seed``) with an MLP
    of ``hidden`` over ``mesh``. Returns ``(es, params)``."""
    policy = MLPPolicy(CartPole.obs_dim, CartPole.act_dim, hidden=hidden)
    es = EvolutionStrategy(
        lambda thetas, states: CartPole.rollout(policy.act, thetas, states,
                                                max_steps=steps),
        CartPole.reset, dim=policy.dim, pop_size=pop, sigma=0.1, lr=0.03,
        mesh=mesh,
        generator=torch.Generator(device=mesh.device).manual_seed(seed + 1))
    return es, policy.init(torch.Generator().manual_seed(seed),
                           device=mesh.device)


def fused_twice(es, params, generations: int):
    """``es.run_fused`` of ``generations`` from ``params``, then again
    from its params, each synchronized and timed: on CUDA the first
    captures the generation's graph and the second only replays it.
    Returns ``(params, stats, first_secs, second_secs)`` of the second
    run."""
    secs = []
    for _ in range(2):
        t0 = time.perf_counter()
        params, stats = es.run_fused(params, generations)
        _sync(es.device)
        secs.append(time.perf_counter() - t0)
    return params, stats, secs[0], secs[1]


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


def _es_setup(env, device, pop, max_steps, sigma, lr, seed, mesh=None):
    """:func:`make_es`'s ``(es, params)`` and the policy, the env's name
    and the episode length that its FLOP count needs; the strategy over
    ``mesh`` when one is given (on ``device``), else one rank."""
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
        lr=lr, device=dev, mesh=mesh,
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
    params, stats, _, secs = fused_twice(es, params, generations)
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


def _finite(t, what):
    if not bool(torch.isfinite(torch.as_tensor(t)).all()):
        raise AssertionError(f"{what}: not finite: {t}")


def _close(got, want, tol, what):
    err = float((got - want).abs().max())
    if not err <= tol:
        raise AssertionError(f"{what}: max abs error {err} > {tol}")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of every population family, one TinyLM AdamW step
    through ring attention, and ring attention (plain and with the flash
    kernel as the per-rank block) against the full-matrix reference,
    all over an ``n_devices``-rank mesh on ``device`` at tiny shapes;
    with 4 or more ranks, an even count, ring attention on the ``(2,
    n/2)`` ``("data", "seq")`` grid too. Raises on a non-finite stat or
    loss, or attention off the reference by more than 2e-5. The JAX
    package's ``dryrun_multichip`` step by step, each draw from its own
    seed (the keys' numbers)."""
    from fiber_tpu_torch.ops import (
        CMAES,
        PGPE,
        MAPElites,
        NoveltyES,
        SepCMAES,
    )
    from fiber_tpu_torch.ops.ring_attention import (
        reference_attention,
        ring_attention,
    )

    dev = resolve_device(device)
    n = int(n_devices)
    mesh = make_mesh(dev, n=n)
    policy = MLPPolicy(CartPole.obs_dim, CartPole.act_dim, hidden=(8,))

    def gen(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def eval_fn(thetas, states):
        return CartPole.rollout(policy.act, thetas, states, max_steps=20)

    es = EvolutionStrategy(eval_fn, CartPole.reset, dim=policy.dim,
                           pop_size=4 * n, sigma=0.1, lr=0.05, mesh=mesh,
                           generator=gen(1))
    params = policy.init(torch.Generator().manual_seed(0), device=dev)
    new_params, stats = es.step(params)
    _finite(stats, "ES stats")
    if new_params.shape != (policy.dim,):
        raise AssertionError(f"ES params shape {tuple(new_params.shape)}")

    for cls, seed in ((PGPE, 3), (SepCMAES, 4), (CMAES, 5)):
        opt = cls(eval_fn, CartPole.reset, dim=policy.dim, pop_size=4 * n,
                  mesh=mesh, generator=gen(seed))
        _, fstats = opt.step(opt.init_state(params))
        _finite(fstats, f"{cls.__name__} stats")

    def eval_bc_fn(thetas, states):
        return eval_fn(thetas, states), torch.stack(
            [torch.tanh(thetas[:, 0]), torch.tanh(thetas[:, 1])], dim=1)

    nes = NoveltyES(eval_bc_fn, CartPole.reset, dim=policy.dim, bc_dim=2,
                    pop_size=4 * n, mesh=mesh, archive_size=16, k=3,
                    adaptive=True, generator=gen(6))
    _, nstats = nes.step(nes.init_state(params))
    _finite(nstats, "NoveltyES stats")
    me = MAPElites(eval_bc_fn, CartPole.reset, dim=policy.dim, bc_dim=2,
                   bc_low=(-1.0, -1.0), bc_high=(1.0, 1.0), cells_per_dim=4,
                   batch_size=2 * n, mesh=mesh, generator=gen(10))
    _, mstats = me.step(me.init_state(params))
    _finite(mstats, "MAPElites stats")

    lm = TinyLM(vocab=16, dim=16, heads=2, layers=1, max_seq=8 * n,
                mesh=mesh, attention="ring",
                generator=torch.Generator().manual_seed(8))
    lm_step = make_train_step(lm, adamw(lm.parameters(), 1e-3))
    toks = torch.randint(0, 16, (8 * n,),
                         generator=torch.Generator().manual_seed(9))
    _finite(lm_step(toks.to(dev)), "TinyLM loss")

    g = torch.Generator().manual_seed(2)
    s, h, d = 8 * n, 2, 8
    q, k, v = (torch.randn(s, h, d, generator=g).to(dev) for _ in range(3))
    with torch.no_grad():
        want = reference_attention(q, k, v, causal=True)
        _close(ring_attention(q, k, v, mesh=mesh, causal=True), want, 2e-5,
               "ring attention")
        _close(ring_attention(q, k, v, mesh=mesh, causal=True,
                              local="flash"), want, 2e-5,
               "ring x flash attention")
        if n >= 4 and n % 2 == 0:
            seq = n // 2
            grid = make_mesh(dev, shape=(2, seq), names=("data", "seq"))
            qb, kb, vb = (torch.randn(4, 8 * seq, h, d, generator=g).to(dev)
                          for _ in range(3))
            want2 = torch.stack([reference_attention(*t, causal=True)
                                 for t in zip(qb, kb, vb)])
            _close(ring_attention(qb, kb, vb, mesh=grid, causal=True), want2,
                   2e-5, "ring attention on the data x seq grid")
    _sync(dev)


def _es_scaling_curve(pop_for_n, mesh_sizes, gens: int, steps: int,
                      device=None) -> list:
    """Fused ES on an n-rank mesh for each n of ``mesh_sizes``, the
    population ``pop_for_n(n)``: a warm-up ``run_fused`` of ``gens``
    generations, then a timed one. One timing row a mesh size."""
    dev = resolve_device(device)
    curve = []
    for n in mesh_sizes:
        es, params = flagship_es(make_mesh(dev, n=n), pop_for_n(n), steps)
        dt = fused_twice(es, params, gens)[3]
        evals = es.pop_size * gens
        curve.append({
            "n_devices": n,
            "pop_size": es.pop_size,
            "wall_sec": round(dt, 4),
            "steps_per_sec": round(gens / dt, 3),
            "evals_per_sec": round(evals / dt, 1),
            "evals_per_sec_per_device": round(evals / dt / n, 1),
        })
    return curve


def weak_scaling(mesh_sizes=(1, 2, 4, 8), gens: int = 20,
                 per_device_pop: int = 256, steps: int = 100,
                 device=None) -> dict:
    """The weak and strong scaling record of the JAX package's
    ``weak_scaling``, over meshes of ``mesh_sizes`` ranks on ``device``.

    Weak curve: the population grows with the rank count
    (``per_device_pop * n``). Strong curve: the same total population
    (``per_device_pop * max(mesh_sizes)``) at every size. Every rank of
    the port's mesh sits on the one device, so the weak curve's
    per-rank throughput falls with n by construction, and the strong
    curve's wall-time growth with n is the per-rank overhead of the
    step (one rollout call for every rank, then a sum of n per-rank
    gradients)."""
    dev = resolve_device(device)
    weak = _es_scaling_curve(lambda n: per_device_pop * n, mesh_sizes, gens,
                             steps, dev)
    total = per_device_pop * max(mesh_sizes)
    strong = _es_scaling_curve(lambda n: total, mesh_sizes, gens, steps,
                               dev)
    wbase = weak[0]["evals_per_sec_per_device"] if weak else None
    sbase = strong[0]["wall_sec"] if strong else None
    return {
        "workload": "fused ES, MLP CartPole "
                    f"({gens} gens, {steps}-step episodes)",
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "weak": {
            "note": ("pop = per_device_pop x n. Every rank sits on one "
                     f"{dev.type} device: the ranks share it, so per-rank "
                     "throughput falls with n by construction; tracks "
                     "gross curve-shape regressions only"),
            "curve": weak,
            "efficiency_vs_1dev": [
                round(c["evals_per_sec_per_device"] / wbase, 3)
                for c in weak
            ] if wbase else [],
        },
        "strong": {
            "note": ("constant total pop = "
                     f"{total} at every mesh size. The ranks share one "
                     "device, so compute is constant in n and wall-time "
                     "growth with n isolates the per-rank dispatch and "
                     "collective overhead of the step"),
            "curve": strong,
            "overhead_vs_1dev": [
                round(c["wall_sec"] / sbase, 3) for c in strong
            ] if sbase else [],
        },
    }


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="python -m fiber_tpu_torch.entry")
    parser.add_argument("n", nargs="?", type=int, default=None,
                        help="ranks of the dry run")
    parser.add_argument("--weak-scaling", action="store_true")
    parser.add_argument("--json", default="",
                        help="file for the --weak-scaling record")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    if args.weak_scaling:
        rec = weak_scaling(device=args.device)
        if args.json:
            with open(args.json, "w") as f:
                json.dump(rec, f, indent=1)
        print(json.dumps(rec))
        return 0
    if args.n is not None:
        dryrun_multichip(args.n, args.device)
        print("dryrun_multichip ok")
        return 0
    fn, fargs = entry(args.device)
    print("entry ok:", fn(*fargs).cpu().numpy())
    dryrun_multichip(min(8, default_mesh(args.device).n_dev), args.device)
    print("dryrun_multichip ok")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
