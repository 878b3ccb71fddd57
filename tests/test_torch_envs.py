"""The port's envs (ParamCartPole, Pendulum, ParamHillWalker,
ParamBipedWalker, PixelChase, the bounded mutation and the recurrent
rollout) against the JAX package on the same inputs, on the CPU.

Random draws differ between the two (threefry vs Philox), so initial
states are derived from the JAX keys exactly as each JAX rollout draws
them (``reset(key)``; the walkers' ``0.1 * normal(key, ())`` and
``0.02 * normal(key, (2,))``; the pixel chase's two ``uniform`` draws
from ``split(key)``) and the mutation noise as ``normal(key, low.shape)``.
The JAX walkers have no step function of their own, so their steps are
compared through the observations that each step hands the policy,
recorded on the JAX side by ``jax.debug.callback`` (in step order, each
step's members in order) and on the port's by the ``act_fn``.

Tolerances: one step of state, reward, slope, height or observation
within 1e-5 (f32 with sin/cos/exp from two libraries); survival returns
exactly (integers); Pendulum returns within 1e-4 relative (200 shaped
rewards summed in f32 to about -1e3, where one f32 step is 1.2e-4, so
an absolute 1e-4 would ask for equal bits); the hill walker's actions
exactly and its final x within 1e-4 relative (see its test); the pixel
chase's returns within 1e-4 (60 steps). The biped is chaotic
(contacts switch on f32 comparisons, and a hull that tips falls), so
its rollouts are compared over 40 steps, its furthest x within 1e-4.
The mutation exactly: both compute the same f32 operations in the same
order on the same noise.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fiber_tpu.models import CartPole as JaxCartPole
from fiber_tpu.models import ConvPolicy as JaxConvPolicy
from fiber_tpu.models import GRUPolicy as JaxGRUPolicy
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.models import ParamBipedWalker as JaxBiped
from fiber_tpu.models import ParamCartPole as JaxParamCartPole
from fiber_tpu.models import ParamHillWalker as JaxHill
from fiber_tpu.models import Pendulum as JaxPendulum
from fiber_tpu.models import PixelChase as JaxPixelChase
from fiber_tpu.models import rollout_recurrent as jax_rollout_recurrent

from fiber_tpu_torch.models.envs import (
    CartPole,
    ParamBipedWalker,
    ParamCartPole,
    ParamHillWalker,
    Pendulum,
    PixelChase,
    mutate_bounded,
    rollout_recurrent,
)
from fiber_tpu_torch.models.policies import ConvPolicy, GRUPolicy, MLPPolicy


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _thetas(jpol, n, seed, scale=0.3):
    base = jpol.init(jax.random.PRNGKey(seed))
    noise = jax.random.normal(jax.random.PRNGKey(seed + 1), (n, jpol.dim))
    return base + scale * noise


def _params_in(cls, n, seed):
    """n env vectors uniform within cls's bounds, from numpy."""
    lo, hi = np.asarray(cls.PARAM_LOW), np.asarray(cls.PARAM_HIGH)
    u = np.random.default_rng(seed).uniform(size=(n, len(lo)))
    return (lo + u * (hi - lo)).astype(np.float32)


def _recording(act):
    """A JAX act_fn that records each observation it is handed."""
    log = []

    def fn(p, o):
        jax.debug.callback(lambda x: log.append(np.asarray(x)), o,
                           ordered=True)
        return act(p, o)

    return fn, log


# -- ParamCartPole ---------------------------------------------------------

@pytest.mark.parametrize("shared", [True, False])
def test_param_cartpole_step_matches_jax(shared):
    """step_p under one physics vector for every row, or one a row,
    including rows that terminate in x and in theta."""
    n = 64
    rng = np.random.default_rng(0)
    states = rng.uniform(-0.2, 0.2, (n, 4)).astype(np.float32)
    states[:4, 0] = [2.45, -2.45, 2.39, -2.39]      # past and at the bound
    states[4:8, 2] = [0.25, -0.25, 0.2, -0.2]
    actions = rng.integers(0, 2, n)
    params = _params_in(ParamCartPole, n, 1)
    if shared:
        params = params[0]
        want_s, want_t = jax.vmap(JaxParamCartPole.step_p,
                                  in_axes=(None, 0, 0))(
            jnp.asarray(params), jnp.asarray(states), jnp.asarray(actions))
    else:
        want_s, want_t = jax.vmap(JaxParamCartPole.step_p)(
            jnp.asarray(params), jnp.asarray(states), jnp.asarray(actions))
    got_s, got_t = ParamCartPole.step_p(_t(params), _t(states), _t(actions))
    assert np.abs(got_s.numpy() - _np(want_s)).max() < 1e-5
    assert got_t.numpy().tolist() == _np(want_t).tolist()
    assert got_t[:2].all() and got_t[4:6].all()


def test_param_cartpole_default_is_cartpole():
    """Under DEFAULT, step_p is CartPole's step."""
    rng = np.random.default_rng(3)
    states = _t(rng.uniform(-0.2, 0.2, (32, 4)).astype(np.float32))
    actions = _t(rng.integers(0, 2, 32))
    got, term = ParamCartPole.step_p(torch.tensor(ParamCartPole.DEFAULT),
                                     states, actions)
    want, want_t = CartPole.step(states, actions)
    assert (got - want).abs().max() < 1e-6
    assert torch.equal(term, want_t)


def test_param_cartpole_rollout_matches_jax():
    jpol = JaxMLPPolicy(4, 2, hidden=(16,))
    pol = MLPPolicy(4, 2, hidden=(16,))
    n = 48
    thetas = _thetas(jpol, n, 5)
    params = _params_in(ParamCartPole, n, 6)
    keys = jax.random.split(jax.random.PRNGKey(7), n)
    want = jax.vmap(lambda e, th, k: JaxParamCartPole.rollout_p(
        jpol.act, e, th, k, max_steps=200))(jnp.asarray(params), thetas,
                                             keys)
    states = jax.vmap(JaxParamCartPole.reset)(keys)
    got = ParamCartPole.rollout_p(pol.act, _t(params), _t(_np(thetas)),
                                  _t(_np(states)), max_steps=200)
    assert got.numpy().tolist() == _np(want).tolist()
    assert len(set(got.tolist())) > 3      # the episodes really differ


@pytest.mark.parametrize("cls,jcls", [
    (ParamCartPole, JaxParamCartPole),
    (ParamHillWalker, JaxHill),
    (ParamBipedWalker, JaxBiped),
])
def test_mutate_matches_jax_exactly(cls, jcls):
    """The bounded mutation on the noise JAX draws from its key; rows
    pushed past a bound by a large draw clip to it."""
    k = len(cls.DEFAULT)
    params = _params_in(cls, 8, 2)
    for i, p in enumerate(params):
        key = jax.random.PRNGKey(10 + i)
        want = _np(jcls.mutate(jnp.asarray(p), key))
        noise = _np(jax.random.normal(key, (k,)))
        got = cls.mutate(_t(p), noise=_t(noise))
        assert got.numpy().tolist() == want.tolist()
    big = _t(np.full(k, 40.0, np.float32))
    hi = cls.mutate(_t(params[0]), noise=big)
    lo = cls.mutate(_t(params[0]), noise=-big)
    assert hi.tolist() == torch.tensor(cls.PARAM_HIGH).tolist()
    assert lo.tolist() == torch.tensor(cls.PARAM_LOW).tolist()


def test_mutate_bounded_draws_from_the_generator():
    p = torch.tensor(ParamCartPole.DEFAULT)
    a = mutate_bounded(p, ParamCartPole.PARAM_LOW, ParamCartPole.PARAM_HIGH,
                       generator=torch.Generator().manual_seed(4))
    b = ParamCartPole.mutate(p, torch.Generator().manual_seed(4))
    noise = torch.randn(4, generator=torch.Generator().manual_seed(4))
    c = ParamCartPole.mutate(p, noise=noise)
    assert torch.equal(a, b) and torch.equal(a, c) and not torch.equal(a, p)
    with pytest.raises(ValueError, match="generator or noise"):
        ParamCartPole.mutate(p)


# -- Pendulum --------------------------------------------------------------

def test_pendulum_step_matches_jax():
    """Angles on both sides of +-pi and beyond one turn (the floor
    modulo of the cost), speeds at the clip, torques past the clip."""
    n = 64
    rng = np.random.default_rng(1)
    states = np.stack([rng.uniform(-8.0, 8.0, n),
                       rng.uniform(-9.0, 9.0, n)], -1).astype(np.float32)
    states[:4, 0] = [np.pi, -np.pi, 3.2, -3.2]
    torque = rng.uniform(-3.0, 3.0, n).astype(np.float32)
    want_s, want_r = jax.vmap(JaxPendulum.step)(jnp.asarray(states),
                                                jnp.asarray(torque))
    got_s, got_r = Pendulum.step(_t(states), _t(torque))
    assert np.abs(got_s.numpy() - _np(want_s)).max() < 1e-5
    assert np.abs(got_r.numpy() - _np(want_r)).max() < 1e-5
    want_o = jax.vmap(JaxPendulum.obs)(jnp.asarray(states))
    assert np.abs(Pendulum.obs(_t(states)).numpy() - _np(want_o)).max() < 1e-5


def test_pendulum_rollout_matches_jax():
    jpol = JaxMLPPolicy(3, 1, hidden=(16,))
    pol = MLPPolicy(3, 1, hidden=(16,))
    n = 32
    thetas = _thetas(jpol, n, 11, scale=1.0)
    keys = jax.random.split(jax.random.PRNGKey(12), n)
    want = jax.vmap(lambda th, k: JaxPendulum.rollout(
        lambda p, o: jpol.apply(p, o)[0], th, k))(thetas, keys)
    states = jax.vmap(JaxPendulum.reset)(keys)
    got = Pendulum.rollout(lambda p, o: pol.apply(p, o)[:, 0],
                           _t(_np(thetas)), _t(_np(states)))
    want = _np(want)
    assert (np.abs(got.numpy() - want)
            <= 1e-4 * np.maximum(1.0, np.abs(want))).all()
    assert got.std() > 1.0


# -- ParamHillWalker -------------------------------------------------------

def test_hill_walker_slope_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.uniform(-20.0, 20.0, 64).astype(np.float32)
    params = _params_in(ParamHillWalker, 64, 3)
    want = jax.vmap(JaxHill.slope)(jnp.asarray(params), jnp.asarray(x))
    got = ParamHillWalker.slope(_t(params), _t(x))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5
    want1 = jax.vmap(JaxHill.slope, in_axes=(None, 0))(
        jnp.asarray(params[0]), jnp.asarray(x))
    got1 = ParamHillWalker.slope(_t(params[0]), _t(x))
    assert np.abs(got1.numpy() - _np(want1)).max() < 1e-5


def test_hill_walker_steps_and_rollout_match_jax():
    """Every step's observation (velocity and three slopes) and action,
    then the final x after the full 200 steps, per-row terrains over
    the whole parameter box. Steep terrain (amplitude 1.2 at frequency
    4.3: a slope that changes by up to 22 a metre, times gravity) makes
    the explicit step amplify f32 differences about tenfold every 20
    steps (3.7e-5 in a slope of 6 after 20), so the observations before
    and after the first step are held to 1e-5, the actions equal at all
    200 steps,
    and the final x to 1e-4 relative."""
    jpol = JaxMLPPolicy(4, 3, hidden=(16,))
    pol = MLPPolicy(4, 3, hidden=(16,))
    n, steps = 24, 200
    thetas = _thetas(jpol, n, 13, scale=1.0)
    params = _params_in(ParamHillWalker, n, 14)
    keys = jax.random.split(jax.random.PRNGKey(15), n)
    act, log = _recording(jpol.act)
    want = _np(jax.vmap(lambda e, th, k: JaxHill.rollout_p(
        act, e, th, k, max_steps=steps))(jnp.asarray(params), thetas, keys))
    want_obs = np.stack(log).reshape(steps, n, 4)
    want_act = np.stack([_np(jax.vmap(jpol.act)(thetas, o))
                         for o in want_obs])
    x0 = jax.vmap(lambda k: 0.1 * jax.random.normal(k, ()))(keys)
    got_obs, got_act = [], []

    def rec(p, o):
        got_obs.append(o.numpy())
        got_act.append(pol.act(p, o))
        return got_act[-1]

    got = ParamHillWalker.rollout_p(rec, _t(params), _t(_np(thetas)),
                                    _t(_np(x0)), max_steps=steps).numpy()
    assert np.abs(np.stack(got_obs[:2]) - want_obs[:2]).max() < 1e-5
    assert torch.stack(got_act).numpy().tolist() == want_act.tolist()
    assert (np.abs(got - want) <= 1e-4 * np.maximum(1.0, np.abs(want))).all()
    assert got.std() > 0.1


# -- ParamBipedWalker ------------------------------------------------------

def test_biped_height_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-5.0, 30.0, 64).astype(np.float32)
    params = _params_in(ParamBipedWalker, 64, 5)
    want = jax.vmap(JaxBiped.height)(jnp.asarray(params), jnp.asarray(x))
    got = ParamBipedWalker.height(_t(params), _t(x))
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5
    # one course for every row, and the (pop, 1, 6) x (pop, m) form the
    # rollout uses for its batched heights
    got1 = ParamBipedWalker.height(_t(params[0]), _t(x))
    want1 = jax.vmap(JaxBiped.height, in_axes=(None, 0))(
        jnp.asarray(params[0]), jnp.asarray(x))
    assert np.abs(got1.numpy() - _np(want1)).max() < 1e-5
    xm = _t(x.reshape(16, 4))
    gotm = ParamBipedWalker.height(_t(params[:16])[:, None], xm)
    wantm = ParamBipedWalker.height(
        _t(params[:16]).repeat_interleave(4, 0), xm.reshape(-1))
    assert torch.equal(gotm.reshape(-1), wantm)


@pytest.mark.parametrize("course", ["flat", "obstacles"])
def test_biped_steps_and_rollout_match_jax(course):
    """40 steps from the JAX keys' jitter under random policies: every
    step's 14 observations (contacts, slopes, clearance) and the
    furthest x. On the obstacle course (every row its own roughness,
    stumps and gaps), some rows fall, and their state freezes."""
    jpol = JaxMLPPolicy(14, 16, hidden=(32, 32))
    pol = MLPPolicy(14, 16, hidden=(32, 32))
    n, steps = 32, 40
    thetas = _thetas(jpol, n, 16, scale=1.0)
    params = (np.zeros((n, 6), np.float32) if course == "flat"
              else _params_in(ParamBipedWalker, n, 17))
    keys = jax.random.split(jax.random.PRNGKey(18), n)
    act, log = _recording(jpol.act)
    want = jax.vmap(lambda e, th, k: JaxBiped.rollout_p(
        act, e, th, k, max_steps=steps))(jnp.asarray(params), thetas, keys)
    want_obs = np.stack(log).reshape(steps, n, 14)
    jitter = jax.vmap(lambda k: 0.02 * jax.random.normal(k, (2,)))(keys)
    assert ParamBipedWalker.reset(5, device="cpu").shape == (5, 2)
    got_obs = []

    def rec(p, o):
        got_obs.append(o.numpy())
        return pol.act(p, o)

    got = ParamBipedWalker.rollout_p(rec, _t(params), _t(_np(thetas)),
                                     _t(_np(jitter)), max_steps=steps)
    got_obs = np.stack(got_obs)
    assert np.abs(got_obs[0] - want_obs[0]).max() < 1e-5
    assert np.abs(got_obs - want_obs).max() < 1e-4
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4
    # contact proxies switch during the episode, and (on the obstacle
    # course) a fallen row's observations stop changing
    contacts = got_obs[:, :, 9:11]
    assert contacts.min() == 0.0 and contacts.max() == 1.0
    if course == "obstacles":
        frozen = (np.abs(np.diff(got_obs[-10:], axis=0)).max(axis=(0, 2))
                  == 0.0)
        assert frozen.any()


# -- PixelChase --------------------------------------------------------------

def test_pixel_chase_render_and_rollout_match_jax():
    """The rendered image, then 30-step returns of a conv policy from the
    JAX keys' agent and target draws."""
    rng = np.random.default_rng(6)
    agent = rng.uniform(2.0, 21.0, (8, 2)).astype(np.float32)
    target = rng.uniform(2.0, 21.0, (8, 2)).astype(np.float32)
    want = jax.vmap(JaxPixelChase._render)(jnp.asarray(agent),
                                           jnp.asarray(target))
    got = PixelChase._render(_t(agent), _t(target))
    assert got.shape == (8, 24, 24, 1)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-5

    jpol = JaxConvPolicy(JaxPixelChase.obs_shape, JaxPixelChase.act_dim,
                         channels=(4, 8), hidden=16)
    pol = ConvPolicy(PixelChase.obs_shape, PixelChase.act_dim,
                     channels=(4, 8), hidden=16)
    n = 8
    thetas = _thetas(jpol, n, 19, scale=1.0)
    keys = jax.random.split(jax.random.PRNGKey(20), n)
    want = jax.vmap(lambda th, k: JaxPixelChase.rollout(
        jpol.act, th, k, max_steps=30))(thetas, keys)

    def start(k):
        k1, k2 = jax.random.split(k)
        return jnp.concatenate([
            jax.random.uniform(k1, (2,), minval=2.0, maxval=21.0),
            jax.random.uniform(k2, (2,), minval=2.0, maxval=21.0)])

    got = PixelChase.rollout(pol.act, _t(_np(thetas)),
                             _t(_np(jax.vmap(start)(keys))), max_steps=30)
    assert np.abs(got.numpy() - _np(want)).max() < 1e-4
    s = PixelChase.reset(1000, torch.Generator().manual_seed(0))
    assert s.shape == (1000, 4) and s.min() >= 2.0 and s.max() < 21.0


# -- the recurrent rollout ---------------------------------------------------

def test_rollout_recurrent_matches_jax():
    """A GRU on CartPole: the carry of a finished row freezes with its
    state, as in JAX's scan; returns exactly."""
    jpol = JaxGRUPolicy(4, 2, hidden=8)
    pol = GRUPolicy(4, 2, hidden=8)
    n = 32
    thetas = _thetas(jpol, n, 21, scale=1.0)
    keys = jax.random.split(jax.random.PRNGKey(22), n)
    want = jax.vmap(lambda th, k: jax_rollout_recurrent(
        JaxCartPole, jpol, th, k, max_steps=120))(thetas, keys)
    states = jax.vmap(JaxCartPole.reset)(keys)
    got = rollout_recurrent(CartPole, pol, _t(_np(thetas)), _t(_np(states)),
                            max_steps=120)
    assert got.numpy().tolist() == _np(want).tolist()
    assert len(set(got.tolist())) > 3 and got.min() < 120
