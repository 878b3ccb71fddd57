"""The port's ES flagship (CartPole, MLPPolicy, centered rank, the ES
step and the entry point) against the JAX package on the same inputs.

Random draws differ between the two (threefry vs Philox), so the JAX
keys are turned into numpy noise and initial states exactly as
``EvolutionStrategy.step`` derives them, and handed to the port. The JAX
strategy gets an explicit one-device mesh: the suite runs JAX on 8
virtual devices, and the default mesh would split the noise over them.

Tolerances: physics states and policy logits within 1e-5 (one f32 step
with sin/cos from two libraries); episode returns, ranks and ES stats
exactly (they are integers or derived from integers); ES parameters
within 1e-6 (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from fiber_tpu.models import CartPole as JaxCartPole
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.ops import EvolutionStrategy as JaxES
from fiber_tpu.ops.es import apply_es_update as jax_update
from fiber_tpu.ops.es import centered_rank as jax_rank

from fiber_tpu_torch.entry import entry, run_es
from fiber_tpu_torch.models.convert import policy_params_from_jax
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops.es import (
    EvolutionStrategy,
    apply_es_update,
    centered_rank,
)
from fiber_tpu_torch.parallel.mesh import Mesh as TorchMesh, make_mesh

HIDDEN = (32, 32)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _policies():
    return (JaxMLPPolicy(4, 2, hidden=HIDDEN), MLPPolicy(4, 2, hidden=HIDDEN))


def _thetas(jpol, n, seed):
    base = jpol.init(jax.random.PRNGKey(seed))
    noise = jax.random.normal(jax.random.PRNGKey(seed + 1), (n, jpol.dim))
    return base + 0.3 * noise


def test_cartpole_step_matches_jax():
    rng = np.random.default_rng(0)
    states = rng.uniform(-0.2, 0.2, (64, 4)).astype(np.float32)
    states[:4, 0] = [2.45, -2.45, 0.0, 0.0]       # out of bounds in x
    states[2:4, 2] = [0.25, -0.25]                 # and in theta
    actions = rng.integers(0, 2, 64)
    want_s, want_t = jax.vmap(JaxCartPole.step)(jnp.asarray(states),
                                                jnp.asarray(actions))
    got_s, got_t = CartPole.step(_t(states), _t(actions))
    assert np.abs(got_s.numpy() - _np(want_s)).max() < 1e-5
    assert got_t.numpy().tolist() == _np(want_t).tolist()
    assert got_t[:4].all()


def test_policy_apply_matches_jax():
    jpol, pol = _policies()
    assert pol.dim == jpol.dim
    thetas = _thetas(jpol, 16, 3)
    obs = jax.random.normal(jax.random.PRNGKey(9), (16, 4))
    want = jax.vmap(jpol.apply)(thetas, obs)
    got = pol.apply(policy_params_from_jax(_np(thetas), device="cpu"),
                    _t(_np(obs)))
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5


def test_rollout_returns_match_jax():
    jpol, pol = _policies()
    thetas = _thetas(jpol, 32, 5)
    keys = jax.random.split(jax.random.PRNGKey(4), 32)
    want = jax.vmap(lambda th, k: JaxCartPole.rollout(
        jpol.act, th, k, max_steps=200))(thetas, keys)
    states = jax.vmap(JaxCartPole.reset)(keys)
    got = CartPole.rollout(pol.act, _t(_np(thetas)), _t(_np(states)),
                           max_steps=200)
    assert got.numpy().tolist() == _np(want).tolist()
    assert len(set(got.tolist())) > 3      # the policies really differ


def test_centered_rank_keeps_tie_order_like_jax():
    fit = np.random.default_rng(1).integers(5, 12, 64).astype(np.float32)
    want = _np(jax_rank(jnp.asarray(fit)))
    got = centered_rank(_t(fit)).numpy()
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("adam", [False, True])
def test_apply_es_update_matches_jax(adam):
    rng = np.random.default_rng(2)
    p, g, m, v = (rng.standard_normal(50).astype(np.float32)
                  for _ in range(4))
    v = np.abs(v)
    kw = dict(lr=0.03, wd=0.01, adam=adam)
    want = jax_update(*(jnp.asarray(a) for a in (p, g, m, v)), 3.0, **kw)
    got = apply_es_update(*(_t(a) for a in (p, g, m, v)), 3.0, **kw)
    for a, b in zip(got[:3], want[:3]):
        assert np.abs(a.numpy() - _np(b)).max() < 1e-6
    assert float(got[3]) == float(want[3])


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_es_step_matches_jax(optimizer):
    jpol, pol = _policies()
    pop, steps = 64, 100
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pool",))

    def jax_eval(theta, key):
        return JaxCartPole.rollout(jpol.act, theta, key, max_steps=steps)

    jes = JaxES(jax_eval, dim=jpol.dim, pop_size=pop, sigma=0.1, lr=0.03,
                mesh=mesh, optimizer=optimizer)
    params = jpol.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(5)
    want_p, want_s = jes.step(params, key)

    # es.py's derivation of the noise and initial states (device 0)
    eps_key, eval_key = jax.random.split(jax.random.fold_in(key, 0))
    eps = jax.random.normal(eps_key, (pop // 2, jpol.dim))
    states = jax.vmap(JaxCartPole.reset)(jax.random.split(eval_key, pop))

    es = EvolutionStrategy(
        lambda th, st: CartPole.rollout(pol.act, th, st, max_steps=steps),
        CartPole.reset, dim=pol.dim, pop_size=pop, sigma=0.1, lr=0.03,
        optimizer=optimizer, device="cpu")
    assert es.pop_size == jes.pop_size and es.mesh.n_dev == 1
    got_p, got_s = es.step(_t(_np(params)), eps=_t(_np(eps)),
                           states=_t(_np(states)))
    assert got_s.numpy().tolist() == _np(want_s).astype(np.float32).tolist()
    assert np.abs(got_p.numpy() - _np(want_p)).max() < 1e-6


def test_reset_optimizer_matches_jax():
    """Adam-mode steps, a reset of the optimizer state, and steps again:
    the same parameters as the JAX strategy's reset-and-rerun on the
    same noise and initial states, within the one-step bound (1e-6) for
    every step taken, as the f32 differences carry over. Without the
    reset the Adam moments carry over and the parameters differ."""
    jpol, pol = _policies()
    pop, steps = 64, 100
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("pool",))

    def jax_eval(theta, key):
        return JaxCartPole.rollout(jpol.act, theta, key, max_steps=steps)

    jes = JaxES(jax_eval, dim=jpol.dim, pop_size=pop, sigma=0.1, lr=0.03,
                mesh=mesh, optimizer="adam")

    def make():
        return EvolutionStrategy(
            lambda th, st: CartPole.rollout(pol.act, th, st,
                                            max_steps=steps),
            CartPole.reset, dim=pol.dim, pop_size=pop, sigma=0.1, lr=0.03,
            optimizer="adam", device="cpu")

    es, keep = make(), make()     # keep never resets
    want = jpol.init(jax.random.PRNGKey(0))
    got = kept = _t(_np(want))
    for gen in range(4):
        if gen == 2:
            jes.reset_optimizer()
            es.reset_optimizer()
            assert es._opt_state is None
        key = jax.random.PRNGKey(10 + gen)
        want, _ = jes.step(want, key)
        # es.py's derivation of the noise and initial states (device 0)
        eps_key, eval_key = jax.random.split(jax.random.fold_in(key, 0))
        eps = _t(_np(jax.random.normal(eps_key, (pop // 2, jpol.dim))))
        states = _t(_np(jax.vmap(JaxCartPole.reset)(
            jax.random.split(eval_key, pop))))
        got, _ = es.step(got, eps=eps, states=states)
        kept, _ = keep.step(kept, eps=eps, states=states)
        assert np.abs(got.numpy() - _np(want)).max() < 1e-6 * (gen + 1)
    assert es._opt_state[2] == 2.0 and keep._opt_state[2] == 4.0
    assert np.abs(kept.numpy() - got.numpy()).max() > 1e-4


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_es_step_over_mesh_matches_jax(optimizer):
    """The 8-rank step against the JAX step on the 8-device mesh: every
    rank's noise and initial states are the JAX device's own
    (``fold_in(key, device)``), handed over rank-major, so the gathered
    fitness has the JAX layout and integer ties rank the same way."""
    jpol, pol = _policies()
    n, pop, steps = 8, 64, 100
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("pool",))

    def jax_eval(theta, key):
        return JaxCartPole.rollout(jpol.act, theta, key, max_steps=steps)

    jes = JaxES(jax_eval, dim=jpol.dim, pop_size=pop, sigma=0.1, lr=0.03,
                mesh=mesh, optimizer=optimizer)
    params = jpol.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(5)
    want_p, want_s = jes.step(params, key)

    eps, states = [], []
    for dev in range(n):
        eps_key, eval_key = jax.random.split(jax.random.fold_in(key, dev))
        eps.append(_np(jax.random.normal(eps_key, (jes.pairs_per_dev,
                                                   jpol.dim))))
        states.append(_np(jax.vmap(JaxCartPole.reset)(
            jax.random.split(eval_key, 2 * jes.pairs_per_dev))))

    es = EvolutionStrategy(
        lambda th, st: CartPole.rollout(pol.act, th, st, max_steps=steps),
        CartPole.reset, dim=pol.dim, pop_size=pop, sigma=0.1, lr=0.03,
        optimizer=optimizer, mesh=make_mesh("cpu", n=n))
    assert es.pop_size == jes.pop_size
    assert es.pairs_per_dev == jes.pairs_per_dev
    got_p, got_s = es.step(_t(_np(params)), eps=_t(np.concatenate(eps)),
                           states=_t(np.concatenate(states)))
    assert es.last_fitness.shape == (n, pop // n)
    assert len(set(es.last_fitness.flatten().tolist())) > 1
    assert got_s.numpy().tolist() == _np(want_s).astype(np.float32).tolist()
    assert np.abs(got_p.numpy() - _np(want_p)).max() < 1e-6


def test_es_run_draws_from_its_generator():
    pol = MLPPolicy(4, 2, hidden=(8,))

    def make():
        return EvolutionStrategy(
            lambda th, st: CartPole.rollout(pol.act, th, st, max_steps=30),
            CartPole.reset, dim=pol.dim, pop_size=33, device="cpu",
            generator=torch.Generator().manual_seed(3))

    es = make()
    assert es.pop_size == 32
    p0 = pol.init(device="cpu")
    pa, hist = es.run(p0, 3, log_every=1)
    pb, _ = make().run(p0, 3)
    assert torch.equal(pa, pb) and len(hist) == 3
    with pytest.raises(ValueError):
        es.step(p0, eps=torch.zeros(3, pol.dim))


def test_es_device_must_match_mesh():
    """A device= that names another device than the mesh's raises, as
    TinyLM's does; the mesh is never built on CUDA here."""
    pol = MLPPolicy(4, 2, hidden=(8,))
    gpu_mesh = TorchMesh((torch.device("cuda", 0),))
    with pytest.raises(ValueError, match="not the mesh's device"):
        EvolutionStrategy(pol.act, CartPole.reset, dim=pol.dim, pop_size=8,
                          device="cpu", mesh=gpu_mesh)
    es = EvolutionStrategy(pol.act, CartPole.reset, dim=pol.dim, pop_size=8,
                           device="cpu", mesh=make_mesh("cpu", n=2))
    assert es.device == torch.device("cpu") and es.mesh.n_dev == 2


def test_entry_matches_jax_entry():
    import __graft_entry__ as graft

    jfn, (jparams, jkeys) = graft.entry()
    want = _np(jax.jit(jfn)(jparams, jkeys))

    fn, (params, states) = entry(device="cpu")
    assert params.shape == (8, MLPPolicy(4, 2, HIDDEN).dim)
    assert states.shape == (8, 4)
    jstates = jax.vmap(JaxCartPole.reset)(jkeys)
    got = fn(_t(_np(jparams)), _t(_np(jstates)))
    assert got.numpy().tolist() == want.tolist()
    own = fn(params, states)
    assert own.shape == (8,) and torch.isfinite(own).all()


def test_run_es_flagship_shape_on_cpu():
    params, stats, perf = run_es(device="cpu", pop=16, max_steps=20,
                                 generations=2)
    assert stats.shape == (2, 3) and torch.isfinite(stats).all()
    assert perf["evals_per_sec"] > 0 and perf["mfu"] is None
    assert params.shape == (MLPPolicy(4, 2, HIDDEN).dim,)
    assert make_mesh("cpu").n_dev == 1


ENTRY_POINTS = ["cartpole_reset", "policy_init", "make_mesh",
                "evolution_strategy", "ask_tell_es", "device_map",
                "device_map_plan", "pgpe", "sep_cma_es", "cma_es",
                "novelty_es", "map_elites", "maze_reset", "state_from_jax",
                "param_cartpole_reset", "pendulum_reset",
                "pixel_chase_reset", "hill_walker_reset", "biped_reset",
                "conv_policy_init", "gru_policy_init", "gru_init_carry",
                "poet", "make_poet", "run_poet", "poet_state_from_jax",
                "make_es_biped", "run_es_biped", "run_es_pixels",
                "make_grid_mesh", "make_poet_ranks"]


@pytest.mark.parametrize("call", ENTRY_POINTS)
def test_es_entry_points_default_to_cuda(call, monkeypatch):
    """With no device named, each entry point of the population-search
    path runs on the card: where there is none it raises rather than fall
    back to the CPU, and it runs on the CPU when the caller asks for it
    by name."""
    from fiber_tpu_torch.entry import make_es, make_poet, run_poet
    from fiber_tpu_torch.models.convert import (
        poet_state_from_jax,
        state_from_jax,
    )
    from fiber_tpu_torch.models.envs import (
        DeceptiveMaze,
        ParamBipedWalker,
        ParamCartPole,
        ParamHillWalker,
        Pendulum,
        PixelChase,
    )
    from fiber_tpu_torch.models.policies import ConvPolicy, GRUPolicy
    from fiber_tpu_torch.ops import (
        CMAES,
        PGPE,
        POET,
        AskTellES,
        MAPElites,
        NoveltyES,
        SepCMAES,
    )
    from fiber_tpu_torch.parallel import DeviceMapPlan, device_map

    pol = MLPPolicy(4, 2, hidden=(8,))

    def bc_eval(thetas, states):
        return thetas.sum(1), thetas[:, :2]

    def map_device(**kw):
        """The device that device_map ran its function on."""
        seen = []
        device_map(lambda x: seen.append(x.device) or x, [1.0, 2.0], **kw)
        return seen[0]

    family = dict(dim=pol.dim, pop_size=8)
    calls = {
        "cartpole_reset": lambda **kw: CartPole.reset(4, **kw),
        "policy_init": lambda **kw: pol.init(**kw),
        "make_mesh": lambda **kw: make_mesh(**kw).device,
        "evolution_strategy": lambda **kw: EvolutionStrategy(
            pol.act, CartPole.reset, dim=pol.dim, pop_size=8, **kw).device,
        "ask_tell_es": lambda **kw: AskTellES(pol.dim, 8, **kw).params,
        "device_map": lambda **kw: map_device(**kw),
        "device_map_plan": lambda **kw: DeviceMapPlan(
            lambda x: x, **kw).mesh.device,
        "pgpe": lambda **kw: PGPE(pol.act, CartPole.reset, **family,
                                  **kw).init_state()[0],
        "sep_cma_es": lambda **kw: SepCMAES(
            pol.act, CartPole.reset, **family, **kw).init_state()[2],
        "cma_es": lambda **kw: CMAES(pol.act, CartPole.reset, **family,
                                     **kw).init_state()[2],
        "novelty_es": lambda **kw: NoveltyES(
            bc_eval, DeceptiveMaze.reset, bc_dim=2, archive_size=4,
            **family, **kw).init_state(torch.zeros(pol.dim)).archive,
        "map_elites": lambda **kw: MAPElites(
            bc_eval, DeceptiveMaze.reset, dim=pol.dim, bc_dim=2,
            bc_low=(-1, -1), bc_high=(1, 1), cells_per_dim=3, batch_size=8,
            **kw).init_state(torch.zeros(pol.dim)).fitness,
        "maze_reset": lambda **kw: DeceptiveMaze.reset(4, **kw),
        "state_from_jax": lambda **kw: state_from_jax(
            [np.zeros(3), np.int32(1)], **kw)[1],
        "param_cartpole_reset": lambda **kw: ParamCartPole.reset(4, **kw),
        "pendulum_reset": lambda **kw: Pendulum.reset(4, **kw),
        "pixel_chase_reset": lambda **kw: PixelChase.reset(4, **kw),
        "hill_walker_reset": lambda **kw: ParamHillWalker.reset(4, **kw),
        "biped_reset": lambda **kw: ParamBipedWalker.reset(4, **kw),
        "conv_policy_init": lambda **kw: ConvPolicy(
            (8, 8, 1), 5, channels=(2,), hidden=4).init(**kw),
        "gru_policy_init": lambda **kw: GRUPolicy(4, 2, 4).init(**kw),
        "gru_init_carry": lambda **kw: GRUPolicy(4, 2, 4).init_carry(
            3, **kw),
        "poet": lambda **kw: POET(ParamCartPole, pol, pop_size=8,
                                  **kw).agents[0],
        "make_poet": lambda **kw: make_poet(pop=8, **kw).envs[0],
        # the history holds no tensor: the device is the one it ran on
        "run_poet": lambda **kw: run_poet(
            pop=8, max_steps=5, iterations=1, es_steps=1, **kw) and (
            torch.device(kw["device"])),
        "poet_state_from_jax": lambda **kw: poet_state_from_jax(
            [np.zeros(4)], [np.zeros(3)], [np.zeros(4)], **kw)[1][0],
        "make_es_biped": lambda **kw: make_es("biped", pop=4, **kw)[1],
        "run_es_biped": lambda **kw: run_es(
            env="biped", pop=4, max_steps=3, **kw)[0],
        "run_es_pixels": lambda **kw: run_es(
            env="pixels", pop=4, max_steps=2, **kw)[0],
        "make_grid_mesh": lambda **kw: make_mesh(
            shape=(2, 2), names=("data", "seq"), **kw).device,
        "make_poet_ranks": lambda **kw: make_poet(
            pop=8, ranks=2, **kw).mesh.device,
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[call]()
    got = calls[call](device="cpu")
    assert getattr(got, "device", got) == torch.device("cpu")
