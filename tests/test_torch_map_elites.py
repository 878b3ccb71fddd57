"""The port's MAPElites against the JAX package on the same inputs, on the
CPU.

Each JAX step draws its parent cells from the whole step key's first
split (uniform over the filled cells), then each device's noise and
maze start positions from ``fold_in`` of the second; the tests derive
them the same way and hand them to the port rank-major, on one device
and on 8. Tolerances: genomes, fitness and behaviors within 1e-6 a step
on a smooth objective; within 1e-5 on the maze (64 f32 steps of a tanh
policy from two libraries); which cells are filled, exactly; the
insertion's winners as a plain reference picks them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fiber_tpu.models import DeceptiveMaze as JaxMaze
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.ops import MAPElites as JaxMAPElites

from fiber_tpu_torch.models.envs import DeceptiveMaze
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops.map_elites import MAPElites, MapElitesState
from fiber_tpu_torch.parallel.mesh import make_mesh

SMOOTH_TOL, MAZE_TOL = 1e-6, 1e-5
TARGET = np.array([0.3, -0.6, 0.2, 0.5], np.float32)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isfinite(got), np.isfinite(want)), what
    ok = np.isfinite(want)
    err = np.abs(got[ok] - want[ok]).max(initial=0.0)
    assert err <= tol, f"{what}: {err} > {tol}"
    assert np.array_equal(got[~ok], want[~ok]), what


def _jax_mesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("pool",))


def _smooth_pair(nan_above=None):
    """A smooth objective, the behavior the first two coordinates; with
    ``nan_above``, children whose first coordinate exceeds it return a
    NaN fitness (a divergent rollout)."""
    def jax_eval(theta, key):
        fit = -jnp.sum((theta - TARGET) ** 2)
        if nan_above is not None:
            fit = jnp.where(theta[0] > nan_above, jnp.nan, fit)
        return fit, theta[:2]

    target = torch.from_numpy(TARGET)

    def torch_eval(thetas, states):
        fit = -((thetas - target) ** 2).sum(1)
        if nan_above is not None:
            fit = torch.where(thetas[:, 0] > nan_above, torch.nan, fit)
        return fit, thetas[:, :2]

    return jax_eval, torch_eval


def _no_states(n, g=None):
    return torch.zeros(n, 1)


def _draws(me, jstate, key, starts=None):
    """A JAX step's draws from its key, rank-major."""
    n = me.mesh.n_dev
    filled = jstate.fitness > -jnp.inf
    p = filled.astype(jnp.float32)
    p = p / jnp.maximum(p.sum(), 1.0)
    sel_key, rest = jax.random.split(key)
    cells = _np(jax.random.choice(sel_key, me.n_cells, (me.batch_size,),
                                  p=p))
    noise, states = [], []
    for dev in range(n):
        eps_key, eval_key = jax.random.split(jax.random.fold_in(rest, dev))
        noise.append(_np(jax.random.normal(eps_key, (me.per_dev, me.dim))))
        if starts is not None:
            states.append(starts(jax.random.split(eval_key, me.per_dev)))
    states = (torch.zeros(me.batch_size, 1) if starts is None
              else _t(np.concatenate(states)))
    return dict(parent_cells=_t(cells), noise=_t(np.concatenate(noise)),
                states=states)


def _check(state, jstate, tol, what):
    for got, want, name in zip(state, jstate, MapElitesState._fields):
        _close(got.numpy(), _np(want), tol, f"{what} {name}")


def _pair(n, nan_above=None, **kw):
    jax_eval, torch_eval = _smooth_pair(nan_above)
    args = dict(dim=4, bc_dim=2, bc_low=(-1.0, -1.0), bc_high=(1.0, 1.0),
                cells_per_dim=6, batch_size=32, sigma=0.3)
    args.update(kw)
    jme = JaxMAPElites(jax_eval, mesh=_jax_mesh(n), **args)
    me = MAPElites(torch_eval, _no_states, mesh=make_mesh("cpu", n=n), **args)
    assert (me.n_cells, me.batch_size, me.per_dev) == (
        jme.n_cells, jme.batch_size, jme.per_dev)
    return jme, me


@pytest.mark.parametrize("n", [1, 8])
def test_map_elites_steps_match_jax(n):
    """One step, then two more, on the smooth objective: the archive
    within 1e-6, the filled cells exactly, stats [qd, coverage, max,
    mean child] within 1e-6 (qd within 1e-5, a sum of up to 36)."""
    jme, me = _pair(n)
    p0 = np.array([0.1, 0.1, 0.0, 0.0], np.float32)
    jstate = jme.init_state(jnp.asarray(p0), jax.random.PRNGKey(0))
    state = me.init_state(_t(p0), torch.zeros(1, 1))
    _check(state, jstate, SMOOTH_TOL, "init")
    key = jax.random.PRNGKey(1)
    coverage = []
    for gen in range(3):
        key, sub = jax.random.split(key)
        draws = _draws(me, jstate, sub)
        jstate, jstats = jme.step(jstate, sub)
        state, stats = me.step(state, **draws)
        _check(state, jstate, SMOOTH_TOL * (gen + 1), f"gen {gen}")
        want = _np(jstats)
        _close(stats[:1], want[:1], 1e-5, "qd")
        _close(stats[1:], want[1:], SMOOTH_TOL, "stats")
        coverage.append(float(stats[1]))
    assert coverage == sorted(coverage) and coverage[-1] > coverage[0]


@pytest.mark.parametrize("n", [1, 8])
def test_map_elites_maze_steps_match_jax(n):
    """The maze example's setting cut down (12 x 12 cells over [-4, 4]^2,
    MLP (16,), sigma 0.2, batch 64): two steps, the archive within
    1e-5 a step and the filled cells exactly."""
    jpol, pol = JaxMLPPolicy(4, 2, hidden=(16,)), MLPPolicy(4, 2, (16,))
    goal = jnp.asarray(JaxMaze.GOAL)

    def jax_eval(theta, key):
        pos = JaxMaze.rollout_xy(jpol.apply, theta, key)
        return -jnp.sqrt(jnp.sum((pos - goal) ** 2)), pos

    def starts(keys):
        return _np(jax.vmap(lambda k: 0.05 * jax.random.normal(k, (2,)))(
            keys))

    args = dict(dim=jpol.dim, bc_dim=2, bc_low=(-4.0, -4.0),
                bc_high=(4.0, 4.0), cells_per_dim=12, batch_size=64,
                sigma=0.2)
    jme = JaxMAPElites(jax_eval, mesh=_jax_mesh(n), **args)
    me = MAPElites(
        lambda th, st: DeceptiveMaze.fitness_and_behavior(pol.apply, th, st),
        DeceptiveMaze.reset, mesh=make_mesh("cpu", n=n), **args)
    init_key = jax.random.PRNGKey(1)
    p0 = jpol.init(jax.random.PRNGKey(0))
    jstate = jme.init_state(p0, init_key)
    state = me.init_state(_t(_np(p0)), _t(starts(init_key[None])))
    _check(state, jstate, MAZE_TOL, "init")
    key = jax.random.PRNGKey(2)
    for gen in range(2):
        key, sub = jax.random.split(key)
        draws = _draws(me, jstate, sub, starts)
        jstate, jstats = jme.step(jstate, sub)
        state, stats = me.step(state, **draws)
        _check(state, jstate, MAZE_TOL * (gen + 1), f"gen {gen}")
        _close(stats[1:], _np(jstats)[1:], MAZE_TOL, "stats")
    assert int(torch.isfinite(state.fitness).sum()) > 5


def test_children_and_incumbent_collide_in_one_cell():
    """A tiny sigma and one filled cell: all 16 children land in the
    incumbent's cell. The best of the 17 wins it, as in JAX; against a
    plain reference, ties go to the highest candidate index."""
    jme, me = _pair(1, batch_size=16, sigma=1e-3)
    p0 = np.array([0.5, 0.5, 0.0, 0.0], np.float32)
    jstate = jme.init_state(jnp.asarray(p0), jax.random.PRNGKey(0))
    state = me.init_state(_t(p0), torch.zeros(1, 1))
    key = jax.random.PRNGKey(3)
    draws = _draws(me, jstate, key)
    assert len(set(draws["parent_cells"].tolist())) == 1
    jstate, _ = jme.step(jstate, key)
    got, stats = me.step(state, **draws)
    _check(got, jstate, SMOOTH_TOL, "collision")
    assert float(stats[1]) == np.float32(1 / me.n_cells)   # still one cell

    # ties: two children equal to each other and better than the
    # incumbent; the later one (highest index) wins
    cell = int(torch.nonzero(torch.isfinite(state.fitness))[0])
    noise = torch.zeros(16, 4)
    noise[3, 2] = noise[9, 2] = 0.1                 # toward TARGET[2]
    got, _ = me.step(state, parent_cells=torch.full((16,), cell),
                     noise=noise, states=torch.zeros(16, 1))
    cand_fit = -((torch.from_numpy(p0) + 1e-3 * noise
                  - torch.from_numpy(TARGET)) ** 2).sum(1)
    best = cand_fit.max()
    assert (cand_fit == best).nonzero().flatten().tolist() == [3, 9]
    assert float(got.fitness[cell]) == float(best)
    want_genome = torch.from_numpy(p0) + 1e-3 * noise[9]
    assert torch.equal(got.genomes[cell], want_genome)


def test_nan_child_loses_and_the_mean_skips_it():
    """Children whose first coordinate passes 0.2 return NaN: none enters
    the archive, the archive matches JAX's, and the mean child fitness is
    the mean of the others (nanmean), as in JAX."""
    jme, me = _pair(1, nan_above=0.2, sigma=0.5)
    p0 = np.array([0.0, 0.0, 0.0, 0.0], np.float32)
    jstate = jme.init_state(jnp.asarray(p0), jax.random.PRNGKey(0))
    state = me.init_state(_t(p0), torch.zeros(1, 1))
    key = jax.random.PRNGKey(6)
    draws = _draws(me, jstate, key)
    children = torch.from_numpy(p0) + 0.5 * draws["noise"]
    n_nan = int((children[:, 0] > 0.2).sum())
    assert 0 < n_nan < me.batch_size
    jstate, jstats = jme.step(jstate, key)
    state, stats = me.step(state, **draws)
    _check(state, jstate, SMOOTH_TOL, "nan")
    assert not torch.isnan(state.fitness).any()
    assert (state.genomes[torch.isfinite(state.fitness), 0] <= 0.2).all()
    _close(stats.numpy(), _np(jstats), 1e-5, "stats")
    assert np.isfinite(float(stats[3]))


def test_elites_order_matches_jax():
    jme, me = _pair(1)
    p0 = np.array([0.1, -0.2, 0.0, 0.0], np.float32)
    jstate = jme.init_state(jnp.asarray(p0), jax.random.PRNGKey(0))
    state = me.init_state(_t(p0), torch.zeros(1, 1))
    key = jax.random.PRNGKey(4)
    for _ in range(2):
        key, sub = jax.random.split(key)
        draws = _draws(me, jstate, sub)
        jstate, _ = jme.step(jstate, sub)
        state, _ = me.step(state, **draws)
    want, got = jme.elites(jstate), me.elites(state)
    assert [c for c, *_ in got] == [c for c, *_ in want]
    assert len(got) == int(torch.isfinite(state.fitness).sum()) > 3
    for (c, f, bc, g), (_, jf, jbc, jg) in zip(got, want):
        assert abs(f - jf) <= 2 * SMOOTH_TOL
        _close(bc, jbc, 2 * SMOOTH_TOL, "bc")
        _close(g, jg, 2 * SMOOTH_TOL, "genome")
        assert int(me._cell_of(torch.from_numpy(bc)[None])) == c


def test_cell_of_truncates_then_clamps():
    _, me = _pair(1)
    bcs = torch.tensor([[-1.0, -1.0], [0.999, 0.999], [-5.0, 7.0],
                        [-0.9, 0.0], [0.34, -0.34]])
    # bins of width 1/3 on [-1, 1]: -0.9 -> 0; 0 -> 3; 0.34 -> 4;
    # -0.34 -> 1 (toward zero from 1.98)
    assert me._cell_of(bcs).tolist() == [0, 35, 5, 3, 25]


def test_map_elites_run_draws_from_its_generator():
    _, torch_eval = _smooth_pair()
    kw = dict(dim=4, bc_dim=2, bc_low=(-1.0, -1.0), bc_high=(1.0, 1.0),
              cells_per_dim=(4, 5), batch_size=33, sigma=0.3,
              mesh=make_mesh("cpu", n=4))

    def make():
        return MAPElites(torch_eval, _no_states,
                         generator=torch.Generator().manual_seed(2), **kw)

    me = make()
    assert me.n_cells == 20 and me.batch_size == 32
    s0 = me.init_state(np.zeros(4))
    a, hist_a = me.run(s0, 4)
    b, hist_b = make().run(s0, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(torch.stack(hist_a), torch.stack(hist_b))
    cov = [float(s[1]) for s in hist_a]
    assert cov == sorted(cov)
    with pytest.raises(ValueError, match="bc_high"):
        MAPElites(torch_eval, _no_states, dim=4, bc_dim=2, bc_low=(0, 0),
                  bc_high=(0, 1), device="cpu")
