"""The port's DeceptiveMaze, knn_novelty, NoveltyES and NoveltyPopulation
against the JAX package on the same inputs, on the CPU.

The maze's start positions come from the JAX keys exactly as the JAX
rollout draws them (``0.05 * normal(key, (2,))``); each NoveltyES step's
draws as its ``device_step`` derives them: the centre's key split off
the step key first, then ``fold_in(key, device)`` split into the noise
key and the evaluation key. Tolerances: maze positions within 1e-5
(64 f32 steps of a tanh policy from two libraries); novelty within 1e-6
relative; NoveltyES parameters and archive within 1e-5 a step (the
archive holds maze positions), ``count``, ``w``, ``best`` and ``stag``
as the JAX values (``best`` within 1e-5, since it is a maze fitness);
``run_fused`` on the CPU exactly N ``step`` calls.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fiber_tpu.models import DeceptiveMaze as JaxMaze
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.ops import NoveltyES as JaxNoveltyES
from fiber_tpu.ops import NoveltyPopulation as JaxNoveltyPopulation
from fiber_tpu.ops import knn_novelty as jax_knn

from fiber_tpu_torch.models.convert import state_from_jax
from fiber_tpu_torch.models.envs import DeceptiveMaze
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops.novelty import (
    NoveltyES,
    NoveltyPopulation,
    NoveltyState,
    knn_novelty,
)
from fiber_tpu_torch.parallel.mesh import make_mesh

POS_TOL = 1e-5
HIDDEN = (16,)
SHORT = 6      # maze steps that stay short of the wall (0.15 a step)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol, what):
    err = np.abs(np.asarray(got, np.float64)
                 - np.asarray(want, np.float64)).max()
    assert err <= tol, f"{what}: {err} > {tol}"


def _policies():
    return JaxMLPPolicy(4, 2, hidden=HIDDEN), MLPPolicy(4, 2, hidden=HIDDEN)


def _starts(keys):
    """The JAX rollout's start positions for each key."""
    return _np(jax.vmap(lambda k: 0.05 * jax.random.normal(k, (2,)))(keys))


def _jax_eval(jpol, steps=None):
    goal = jnp.asarray(JaxMaze.GOAL)

    def eval_bc(theta, key):
        pos = JaxMaze.rollout_xy(jpol.apply, theta, key, steps)
        return -jnp.sqrt(jnp.sum((pos - goal) ** 2)), pos

    return eval_bc


def _torch_eval(pol, steps=None):
    def eval_bc(thetas, states):
        return DeceptiveMaze.fitness_and_behavior(pol.apply, thetas, states,
                                                  steps)

    return eval_bc


def test_maze_rollout_matches_jax_including_the_wall():
    """32 random policies and 8 that drive straight up into the wall
    (zero weights, output bias (0, 5)): the same final positions, and the
    wall parks the 8 just below it."""
    jpol, pol = _policies()
    base = jpol.init(jax.random.PRNGKey(0))
    noise = jax.random.normal(jax.random.PRNGKey(1), (32, jpol.dim))
    thetas = np.concatenate([_np(base + 1.5 * noise),
                             np.zeros((8, jpol.dim), np.float32)])
    thetas[32:, -1] = 5.0                  # the output layer's vy bias
    keys = jax.random.split(jax.random.PRNGKey(2), 40)
    want = _np(jax.vmap(lambda th, k: JaxMaze.rollout_xy(
        jpol.apply, th, k))(jnp.asarray(thetas), keys))
    got = DeceptiveMaze.rollout_xy(pol.apply, _t(thetas), _t(_starts(keys)))
    _close(got.numpy(), want, POS_TOL, "positions")
    assert np.allclose(got[32:, 1].numpy(), DeceptiveMaze.WALL_Y - 1e-3)
    assert len(np.unique(np.round(want[:32], 3), axis=0)) > 20
    fit = DeceptiveMaze.rollout(pol.apply, _t(thetas), _t(_starts(keys)))
    want_fit = _np(jax.vmap(lambda th, k: JaxMaze.rollout(
        jpol.apply, th, k))(jnp.asarray(thetas), keys))
    _close(fit.numpy(), want_fit, POS_TOL, "fitness")


def test_maze_reset_draws_on_the_generator():
    g = torch.Generator().manual_seed(4)
    pos = DeceptiveMaze.reset(1000, g)
    assert pos.shape == (1000, 2) and pos.device == torch.device("cpu")
    assert 0.04 < float(pos.std()) < 0.06


@pytest.mark.parametrize("count", [0, 3, 12, 40])
def test_knn_novelty_matches_jax(count):
    """``count`` below k (3), a ring partly full (12 of 32), one wrapped
    past its capacity (40), and an empty archive (0), whose dead slots
    hold values that would be near neighbours if they counted; there every
    novelty is inf in both."""
    rng = np.random.default_rng(count)
    bcs = rng.standard_normal((64, 3)).astype(np.float32)
    archive = rng.standard_normal((32, 3)).astype(np.float32)
    want = _np(jax_knn(jnp.asarray(bcs), jnp.asarray(archive),
                       jnp.asarray(count, jnp.int32), 10))
    for c in (count, torch.tensor(count, dtype=torch.int32)):
        got = knn_novelty(_t(bcs), _t(archive), c, 10).numpy()
        assert np.allclose(got, want, rtol=1e-6, atol=1e-6)
    if count == 0:                  # no live row: every novelty is inf
        assert np.isinf(want).all()


def test_knn_novelty_k_above_capacity():
    rng = np.random.default_rng(9)
    bcs = rng.standard_normal((8, 2)).astype(np.float32)
    archive = rng.standard_normal((4, 2)).astype(np.float32)
    want = _np(jax_knn(jnp.asarray(bcs), jnp.asarray(archive), 4, 10))
    got = knn_novelty(_t(bcs), _t(archive), 4, 10).numpy()
    assert np.allclose(got, want, rtol=1e-6, atol=1e-6)


def _novelty_draws(key, n, pairs, dim):
    """A NoveltyES step's draws from its key: the centre's start
    position, then every device's noise and start positions,
    rank-major."""
    key, center_key = jax.random.split(key)
    eps, states = [], []
    for dev in range(n):
        eps_key, eval_key = jax.random.split(jax.random.fold_in(key, dev))
        eps.append(_np(jax.random.normal(eps_key, (pairs, dim))))
        states.append(_starts(jax.random.split(eval_key, 2 * pairs)))
    return dict(eps=_t(np.concatenate(eps)),
                states=_t(np.concatenate(states)),
                center_state=_t(_starts(center_key[None])))


def _check_state(state, jstate, gen):
    jp, ja, jc, jw, jb, js = (_np(x) for x in jstate)
    _close(state.params, jp, POS_TOL * (gen + 1), "params")
    _close(state.archive, ja, POS_TOL * (gen + 1), "archive")
    assert int(state.count) == int(jc)
    assert state.count.dtype == torch.int32 == state.stag.dtype
    assert float(state.w) == float(np.float32(jw))
    if np.isfinite(jb):
        _close(state.best, jb, POS_TOL, "best")
    else:
        assert float(state.best) == float(jb)
    assert int(state.stag) == int(js)


MODES = {"ns": dict(reward_weight=0.0),
         "nsr": dict(reward_weight=0.5),
         "nsra": dict(reward_weight=0.5, adaptive=True, weight_delta=0.1,
                      patience=2)}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("n", [1, 8])
def test_novelty_es_steps_match_jax(mode, n):
    """Three steps on the maze at pop 64, archive 16, k 5, in each mode:
    the JAX archive, count, w, best
    and stag, and stats (the mean and max maze fitness within 1e-5, mean
    novelty within 1e-5, w exactly). Episodes of SHORT steps, so that no
    member reaches the wall: the wall parks behaviors on one line, and
    the mean distance to two archived points on a line is the same for
    every point between them; such exact ties of the geometry rank by
    f32 noise in either library."""
    jpol, pol = _policies()
    kw = dict(pop_size=64, sigma=0.1, lr=0.05, archive_size=16, k=5,
              **MODES[mode])
    jnes = JaxNoveltyES(_jax_eval(jpol, SHORT), dim=jpol.dim, bc_dim=2,
                        mesh=JaxMesh(np.asarray(jax.devices()[:n]),
                                     ("pool",)), **kw)
    nes = NoveltyES(_torch_eval(pol, SHORT), DeceptiveMaze.reset,
                    dim=pol.dim,
                    bc_dim=2, mesh=make_mesh("cpu", n=n), **kw)
    assert nes.pairs_per_dev == jnes.pairs_per_dev
    init_key = jax.random.PRNGKey(2)
    jstate = jnes.init_state(jpol.init(jax.random.PRNGKey(0)), init_key)
    state = nes.init_state(_t(_np(jstate.params)),
                           _t(_starts(init_key[None])))
    _check_state(state, jstate, 0)
    key = jax.random.PRNGKey(3)
    ws = []
    for gen in range(3):
        key, sub = jax.random.split(key)
        jstate, jstats = jnes.step(jstate, sub)
        state, stats = nes.step(state, **_novelty_draws(
            sub, n, jnes.pairs_per_dev, jpol.dim))
        assert isinstance(state, NoveltyState)
        _check_state(state, jstate, gen + 1)
        want = _np(jstats)
        _close(stats[:3], want[:3], POS_TOL, "stats")
        assert float(stats[3]) == float(want[3])
        ws.append(float(state.w))
    assert int(state.count) == 4
    if mode == "nsra":
        assert len(set(ws)) > 1                    # the weight moved
    assert float(state.archive[:, 1].max()) < DeceptiveMaze.WALL_Y


def test_novelty_state_from_jax_steps_alike():
    """A JAX state carried across with ``state_from_jax`` steps as the
    JAX state does."""
    jpol, pol = _policies()
    kw = dict(pop_size=16, archive_size=8, k=3, reward_weight=0.5)
    jnes = JaxNoveltyES(_jax_eval(jpol, SHORT), dim=jpol.dim, bc_dim=2,
                        mesh=JaxMesh(np.asarray(jax.devices()[:1]),
                                     ("pool",)), **kw)
    nes = NoveltyES(_torch_eval(pol, SHORT), DeceptiveMaze.reset,
                    dim=pol.dim, bc_dim=2, device="cpu", **kw)
    jstate = jnes.init_state(jpol.init(jax.random.PRNGKey(0)),
                             jax.random.PRNGKey(1))
    state = NoveltyState(*state_from_jax([_np(x) for x in jstate],
                                         device="cpu"))
    key = jax.random.PRNGKey(8)
    jstate, _ = jnes.step(jstate, key)
    state, _ = nes.step(state, **_novelty_draws(key, 1, 8, jpol.dim))
    _check_state(state, jstate, 1)


@pytest.mark.parametrize("n", [1, 8])
def test_novelty_run_fused_is_n_steps(n):
    """On the CPU ``run_fused`` loops the generation: the same draws and
    arithmetic as N ``step`` calls, the ring wrapping past its capacity
    on the way (4 slots, 1 + 5 admissions), a NoveltyState back."""
    pol = MLPPolicy(4, 2, hidden=(8,))

    def make():
        return NoveltyES(_torch_eval(pol), DeceptiveMaze.reset,
                         dim=pol.dim, bc_dim=2, pop_size=32,
                         archive_size=4, k=3, adaptive=True, patience=2,
                         mesh=make_mesh("cpu", n=n),
                         generator=torch.Generator().manual_seed(5))

    fused, eager = make(), make()
    state0 = fused.init_state(pol.init(device="cpu"))
    eager.init_state(pol.init(device="cpu"))       # the same draw
    got, stats = fused.run_fused(state0, 5)
    want, rows = eager.run(state0, 5)
    assert isinstance(got, NoveltyState) and stats.shape == (5, 4)
    assert torch.equal(stats, torch.stack(rows))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(got.count) == 6
    assert torch.equal(fused.generator.get_state(),
                       eager.generator.get_state())


def test_novelty_population_matches_jax_with_injected_picks():
    """Three agents on one archive: the seed behaviors fold in agent
    order, and with the JAX pick handed over, each of two steps leaves
    the agents and the shared archive as the JAX population's, the pick's
    probabilities the JAX ones within 1e-5 (maze novelties)."""
    jpol, pol = _policies()
    kw = dict(pop_size=16, archive_size=32, k=3, reward_weight=0.5)
    jnes = JaxNoveltyES(_jax_eval(jpol, SHORT), dim=jpol.dim, bc_dim=2,
                        mesh=JaxMesh(np.asarray(jax.devices()[:1]),
                                     ("pool",)), **kw)
    nes = NoveltyES(_torch_eval(pol, SHORT), DeceptiveMaze.reset,
                    dim=pol.dim, bc_dim=2, device="cpu", **kw)
    jpop, pop = JaxNoveltyPopulation(jnes, 3), NoveltyPopulation(nes, 3)
    params0 = [jpol.init(jax.random.PRNGKey(i)) for i in range(3)]
    key = jax.random.PRNGKey(4)
    jpop.init(params0, key)
    pop.init([_t(_np(p)) for p in params0],
             _t(_starts(jax.random.split(key, 3))))
    for jst, st in zip(jpop._states, pop._states):
        _check_state(st, jst, 0)
    assert int(pop._states[0].count) == 3
    for gen in range(2):
        key, step_key = jax.random.split(key)
        sel_key, eval_key, nes_key = jax.random.split(step_key, 3)
        # the JAX pick's probabilities, from the agents and the archive
        # before the step, as NoveltyPopulation.step computes them
        eval_keys = [jax.random.fold_in(eval_key, i) for i in range(3)]
        bcs = jnp.stack([jnes.eval_fn(st.params, k)[1]
                         for st, k in zip(jpop._states, eval_keys)])
        nov = jax_knn(bcs, jpop._states[0].archive, jpop._states[0].count,
                      jnes.k)
        want_probs = _np(nov / nov.sum())
        pick, jstats = jpop.step(step_key)
        eval_states = _t(_starts(jnp.stack(eval_keys)))
        got_pick, stats = pop.step(pick=pick, eval_states=eval_states,
                                   **_novelty_draws(nes_key, 1, 8,
                                                    jpol.dim))
        assert got_pick == pick
        _close(pop.last_probs, want_probs, 1e-5, "pick probabilities")
        for jst, st in zip(jpop._states, pop._states):
            _check_state(st, jst, gen + 1)
        _close(stats[:3], _np(jstats)[:3], POS_TOL, "stats")
    assert int(pop._states[0].count) == 5


def test_novelty_population_falls_back_to_a_uniform_pick():
    """Every agent's behavior already in the archive: all novelties are
    0, and the pick is uniform, drawn on the host."""
    def still(thetas, states):
        return torch.zeros(thetas.shape[0]), torch.zeros(thetas.shape[0], 2)

    nes = NoveltyES(still, lambda n, g: torch.zeros(n, 2), dim=3, bc_dim=2,
                    pop_size=8, archive_size=8, k=2, device="cpu")
    pop = NoveltyPopulation(nes, 4)
    pop.init([np.zeros(3)] * 4)
    pick, _ = pop.step()
    assert pop.last_probs.tolist() == [0.25] * 4
    assert 0 <= pick < 4
    with pytest.raises(ValueError, match="agents"):
        NoveltyPopulation(nes, 0)
    with pytest.raises(ValueError, match="parameter vectors"):
        pop.init([np.zeros(3)])
