"""The port's PGPE, SepCMAES and CMAES against the JAX package on the
same inputs, on the CPU.

Each JAX step draws its noise and CartPole start states from its key
(``fold_in(key, device)``, then the split into a noise key and an
evaluation key); the tests derive them the same way and hand them to
the port rank-major, on a one-device mesh and on 8 devices. Tolerances:
stats that derive from integer returns (mean and max fitness) exactly;
every other state leaf within 1e-6 a step, CMA's covariance within 1e-5
(f32 sums in another order, carried over); ``run_fused`` on the CPU
exactly equal to N ``step`` calls from the same generator state.

Full CMA factors C with ``eigh``, whose eigenvectors LAPACK and XLA fix
only up to sign, and within near-equal eigenvalues up to a rotation.
Each generation the tests align them: with ``B_jax`` and ``B_torch``
from the two states' symmetrised C, ``M = B_jax^T B_torch`` and the port
gets ``z M``. M is orthogonal, ``B_torch = B_jax M``, and M commutes with
D wherever D's entries differ by more than the f32 noise: its diagonal
is ``S = sign(diag(B_jax^T B_torch))`` where the eigenvalues are well
apart, and a small rotation inside a near-equal pair (generation 1 has
gaps of 4e-5 at dim 30). So ``y = (z M D) (B_jax M)^T`` and ``B_torch
<z M>_w`` are the JAX values, within the same 1e-6 a step. At
generation 0, C = I is degenerate, and both libraries return I, so M =
I.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fiber_tpu.models import CartPole as JaxCartPole
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.ops import CMAES as JaxCMAES
from fiber_tpu.ops import PGPE as JaxPGPE
from fiber_tpu.ops import SepCMAES as JaxSepCMAES

from fiber_tpu_torch.models.convert import state_from_jax
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops.cma import CMAES, SepCMAES
from fiber_tpu_torch.ops.pgpe import PGPE
from fiber_tpu_torch.parallel.mesh import make_mesh

STEPS = 100
STATE_TOL, COV_TOL = 1e-6, 1e-5


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _pair(hidden):
    jpol = JaxMLPPolicy(4, 2, hidden=hidden)
    pol = MLPPolicy(4, 2, hidden=hidden)

    def jax_eval(theta, key):
        return JaxCartPole.rollout(jpol.act, theta, key, max_steps=STEPS)

    def torch_eval(thetas, states):
        return CartPole.rollout(pol.act, thetas, states, max_steps=STEPS)

    return jpol, pol, jax_eval, torch_eval


def _jax_mesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("pool",))


def _pgpe_draws(key, n, pairs, dim):
    z, states = [], []
    for dev in range(n):
        z_key, eval_key = jax.random.split(jax.random.fold_in(key, dev))
        z.append(_np(jax.random.normal(z_key, (pairs, dim))))
        states.append(_np(jax.vmap(JaxCartPole.reset)(
            jax.random.split(eval_key, 2 * pairs))))
    return _t(np.concatenate(z)), _t(np.concatenate(states))


def _close(got, want, tol, what):
    err = np.abs(np.asarray(got, np.float64)
                 - np.asarray(want, np.float64)).max()
    assert err <= tol, f"{what}: {err} > {tol}"


@pytest.mark.parametrize("n", [1, 8])
def test_pgpe_steps_match_jax(n):
    """One step, then two more: (mu, sigma) within 1e-6 a step, mean and
    max fitness exactly, mean sigma within 1e-6."""
    jpol, pol, jax_eval, torch_eval = _pair((32, 32))
    pop = 64
    jpg = JaxPGPE(jax_eval, dim=jpol.dim, pop_size=pop, sigma_init=0.1,
                  mesh=_jax_mesh(n))
    pg = PGPE(torch_eval, CartPole.reset, dim=pol.dim, pop_size=pop,
              sigma_init=0.1, mesh=make_mesh("cpu", n=n))
    assert (pg.pop_size, pg.pairs_per_dev) == (jpg.pop_size,
                                               jpg.pairs_per_dev)
    jstate = jpg.init_state(jpol.init(jax.random.PRNGKey(0)))
    state = state_from_jax([_np(x) for x in jstate], device="cpu")
    assert state[0].device == torch.device("cpu")
    key = jax.random.PRNGKey(5)
    for gen in range(3):
        key, sub = jax.random.split(key)
        jstate, jstats = jpg.step(jstate, sub)
        z, states = _pgpe_draws(sub, n, jpg.pairs_per_dev, jpol.dim)
        state, stats = pg.step(state, z=z, states=states)
        want = _np(jstats)
        assert stats[:2].tolist() == want[:2].astype(np.float32).tolist()
        _close(stats[2], want[2], STATE_TOL, "mean sigma")
        for got, ref, name in zip(state, jstate, ("mu", "sigma")):
            _close(got, _np(ref), STATE_TOL * (gen + 1), name)
    assert float(state[1].min()) >= pg.sigma_floor
    assert (state[1] != 0.1).any()                    # sigma adapted


def _cma_pair(cls, jcls, hidden, pop, n):
    jpol, pol, jax_eval, torch_eval = _pair(hidden)
    jcma = jcls(jax_eval, dim=jpol.dim, pop_size=pop, mesh=_jax_mesh(n))
    cma = cls(torch_eval, CartPole.reset, dim=pol.dim, pop_size=pop,
              mesh=make_mesh("cpu", n=n))
    for name in ("pop_size", "lam_per_dev", "mu", "mu_eff", "c_sigma",
                 "d_sigma", "c_c", "c_1", "c_mu", "chi_n"):
        assert getattr(cma, name) == getattr(jcma, name), name
    return jpol, jcma, cma


def _cma_draws(key, n, lam_dev, dim):
    z, states = [], []
    for dev in range(n):
        z_key, eval_key = jax.random.split(jax.random.fold_in(key, dev))
        z.append(_np(jax.random.normal(z_key, (lam_dev, dim))))
        states.append(_np(jax.vmap(JaxCartPole.reset)(
            jax.random.split(eval_key, lam_dev))))
    return _t(np.concatenate(z)), _t(np.concatenate(states))


def _check_cma(state, jstate, stats, jstats, gen):
    want = _np(jstats)
    assert stats[:2].tolist() == want[:2].astype(np.float32).tolist()
    _close(stats[2], want[2], STATE_TOL * (gen + 1), "sigma stat")
    names = ("m", "sigma", "C", "p_sigma", "p_c")
    for got, ref, name in zip(state[:5], jstate[:5], names):
        tol = COV_TOL if name == "C" else STATE_TOL
        _close(got, _np(ref), tol * (gen + 1), name)
    assert int(state[5]) == int(jstate[5]) == gen + 1
    assert state[5].dtype == torch.int32


@pytest.mark.parametrize("n", [1, 8])
def test_sep_cma_steps_match_jax(n):
    jpol, jcma, cma = _cma_pair(SepCMAES, JaxSepCMAES, (32, 32), 64, n)
    jstate = jcma.init_state(jpol.init(jax.random.PRNGKey(0)))
    state = state_from_jax([_np(x) for x in jstate], device="cpu")
    key = jax.random.PRNGKey(7)
    for gen in range(3):
        key, sub = jax.random.split(key)
        jstate, jstats = jcma.step(jstate, sub)
        z, states = _cma_draws(sub, n, jcma.lam_per_dev, jpol.dim)
        state, stats = cma.step(state, z=z, states=states)
        _check_cma(state, jstate, stats, jstats, gen)


def _eig(C):
    """Eigenvalues and eigenvectors of the port's symmetrised C, as its
    step factors it."""
    return torch.linalg.eigh(0.5 * (C + C.T))


@pytest.mark.parametrize("n", [1, 8])
def test_full_cma_steps_match_jax_with_aligned_eigenvectors(n):
    """hidden (4,): dim 30, pop 64; the eigenvectors aligned by M each
    generation (module docstring)."""
    jpol, jcma, cma = _cma_pair(CMAES, JaxCMAES, (4,), 64, n)
    jstate = jcma.init_state(jpol.init(jax.random.PRNGKey(0)))
    state = state_from_jax([_np(x) for x in jstate], device="cpu")
    key = jax.random.PRNGKey(9)
    for gen in range(3):
        _, b_jax = jnp.linalg.eigh(0.5 * (jstate[2] + jstate[2].T))
        _, b_torch = _eig(state[2])
        b_jax = _np(b_jax)
        if gen == 0:
            # C = I: both libraries return I itself
            eye = np.eye(jpol.dim, dtype=np.float32)
            assert np.array_equal(b_jax, eye)
            assert torch.equal(b_torch, torch.from_numpy(eye))
        align = torch.from_numpy(b_jax.T @ b_torch.numpy())
        # orthogonal, and a sign flip on most axes
        _close(align @ align.T, np.eye(jpol.dim), 1e-5, "M orthogonal")
        assert (torch.diagonal(align).abs() > 0.99).float().mean() > 0.8
        key, sub = jax.random.split(key)
        jstate, jstats = jcma.step(jstate, sub)
        z, states = _cma_draws(sub, n, jcma.lam_per_dev, jpol.dim)
        state, stats = cma.step(state, z=z @ align, states=states)
        _check_cma(state, jstate, stats, jstats, gen)


@pytest.mark.parametrize("family", ["pgpe", "sep_cma", "cma"])
@pytest.mark.parametrize("n", [1, 8])
def test_run_fused_is_n_steps(family, n):
    """On the CPU ``run_fused`` loops the generation (CMAES with its eigh
    as the eager prep): the same draws and arithmetic as N ``step``
    calls, so states, stats and the generator's state are equal."""
    pol = MLPPolicy(4, 2, hidden=(8,))
    cls = {"pgpe": PGPE, "sep_cma": SepCMAES, "cma": CMAES}[family]

    def make():
        return cls(lambda th, st: CartPole.rollout(pol.act, th, st,
                                                   max_steps=40),
                   CartPole.reset, dim=pol.dim, pop_size=32,
                   mesh=make_mesh("cpu", n=n),
                   generator=torch.Generator().manual_seed(3))

    fused, eager = make(), make()
    assert (cls is CMAES) == (fused._eager_prep is not None)
    state0 = fused.init_state(pol.init(device="cpu"))
    got, got_stats = fused.run_fused(state0, 4)
    want, rows = eager.run(state0, 4)
    assert got_stats.shape == (4, 3)
    assert torch.equal(got_stats, torch.stack(rows))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(fused.generator.get_state(),
                       eager.generator.get_state())
    assert len(set(got_stats[:, 0].tolist())) > 1


def test_sep_cma_converges_on_the_quadratic():
    """As the JAX package's own test asks of SepCMAES (8 ranks, dim 6,
    pop 64, 60 generations): the mean closes in on the target, the step
    size adapts and the diagonal covariance stays positive."""
    target = torch.tensor([0.5, -0.3, 0.8, 0.0, 0.2, -0.7])

    def quadratic(thetas, states):
        return -((thetas - target) ** 2).sum(1)

    cma = SepCMAES(quadratic, lambda n, g: torch.zeros(n, 1), dim=6,
                   pop_size=64, sigma_init=0.3, mesh=make_mesh("cpu", n=8))
    state = cma.init_state()
    d0 = float(((state[0] - target) ** 2).sum())
    state, history = cma.run(state, 60)
    d1 = float(((state[0] - target) ** 2).sum())
    assert d1 < d0 * 0.05, (d0, d1)
    assert bool((state[2] > 0).all())
    assert abs(float(state[1]) - cma.sigma_init) > 1e-3
    assert torch.isfinite(history[-1]).all()


def test_init_state_checks_its_shape():
    for cls in (PGPE, SepCMAES, CMAES):
        algo = cls(lambda th, st: th.sum(1), CartPole.reset, dim=5,
                   pop_size=8, device="cpu")
        with pytest.raises(ValueError, match="shape"):
            algo.init_state(np.zeros(4))
        state = algo.init_state(np.ones(5))
        assert state[0].dtype == torch.float32 and state[0].shape == (5,)
        with pytest.raises(ValueError, match="env states"):
            algo.step(state, states=torch.zeros(3, 4))
