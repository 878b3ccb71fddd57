"""The port's fused ES runner (``run_fused``, ``build_fused_runner``,
``run_steps``), Adam's step count as a tensor, the batched mesh step and
``run_es``, on the CPU.

``run_fused`` is held against the JAX package's ``run_fused`` over 1 and
8 devices, with every generation's noise and initial states derived from
the JAX runner's keys and fed to the port's draws: stats exactly (they
derive from integer returns), params within 1e-6 a generation (f32 sums
in another order, carried over), as ``tests/test_torch_es.py`` holds one
step. On the CPU ``run_fused`` loops the step, so it must also give
exactly the trajectory of N ``step`` calls from the same generator
state: the same draws in the same order, the same arithmetic. The
CUDA-graph replay is held to that trajectory on the card by
``chip_smoke.py``. The update with a tensor step count is held against
the JAX update within 1e-6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fiber_tpu.models import CartPole as JaxCartPole
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.ops import EvolutionStrategy as JaxES
from fiber_tpu.ops.es import apply_es_update as jax_update

from fiber_tpu_torch.entry import run_es
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops import es as es_mod
from fiber_tpu_torch.ops.es import (
    EvolutionStrategy,
    apply_es_update,
    build_fused_runner,
    run_steps,
)
from fiber_tpu_torch.parallel.mesh import Mesh, make_mesh

POLICY = MLPPolicy(4, 2, hidden=(8, 8))
POP, STEPS, GENS = 64, 40, 4


def _make(optimizer="sgd", n=1, eval_calls=None, seed=3):
    def rollout(thetas, states):
        if eval_calls is not None:
            eval_calls.append(thetas.shape[0])
        return CartPole.rollout(POLICY.act, thetas, states, max_steps=STEPS)

    return EvolutionStrategy(
        rollout, CartPole.reset, dim=POLICY.dim, pop_size=POP, sigma=0.1,
        lr=0.03, optimizer=optimizer, mesh=make_mesh("cpu", n=n),
        generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_run_fused_is_n_steps(optimizer, n):
    fused, eager = _make(optimizer, n), _make(optimizer, n)
    p0 = POLICY.init(device="cpu")
    got_p, got_s = fused.run_fused(p0, GENS)
    p, rows = p0, []
    for _ in range(GENS):
        p, s = eager.step(p)
        rows.append(s)
    assert got_s.shape == (GENS, 3)
    assert torch.equal(got_s, torch.stack(rows))
    assert len(set(got_s[:, 0].tolist())) > 1      # the policy moved
    assert torch.equal(got_p, p)
    assert torch.equal(fused.generator.get_state(),
                       eager.generator.get_state())
    assert torch.equal(fused.last_fitness, eager.last_fitness)
    if optimizer == "adam":
        assert all(torch.equal(a, b) for a, b in zip(fused._opt_state,
                                                     eager._opt_state))
    else:
        assert fused._opt_state is None and eager._opt_state is None


def _jax_draws(key, generations, n, pairs, dim):
    """The noise (pairs * n, dim) and initial states (2 * pairs * n, 4)
    of each generation of the JAX fused runner, rank-major: its key
    split per generation, then each device's ``fold_in`` as its device
    step derives them."""
    draws = []
    for _ in range(generations):
        key, sub = jax.random.split(key)
        eps, states = [], []
        for dev in range(n):
            eps_key, eval_key = jax.random.split(jax.random.fold_in(sub, dev))
            eps.append(np.asarray(jax.random.normal(eps_key, (pairs, dim))))
            states.append(np.asarray(jax.vmap(JaxCartPole.reset)(
                jax.random.split(eval_key, 2 * pairs))))
        draws.append((torch.from_numpy(np.concatenate(eps)),
                      torch.from_numpy(np.concatenate(states))))
    return draws


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_run_fused_matches_jax(optimizer, n):
    """GENS generations of ``run_fused`` against the JAX package's
    ``run_fused`` on an n-device mesh. The two draw from different
    generators (threefry vs Philox), so the port's noise and state draws
    hand over the JAX runner's, in the order the port's step draws them.
    """
    jpol = JaxMLPPolicy(4, 2, hidden=(8, 8))
    assert jpol.dim == POLICY.dim
    jes = JaxES(lambda th, key: JaxCartPole.rollout(jpol.act, th, key,
                                                    max_steps=STEPS),
                dim=jpol.dim, pop_size=POP, sigma=0.1, lr=0.03,
                optimizer=optimizer,
                mesh=JaxMesh(np.asarray(jax.devices()[:n]), ("pool",)))
    params = jpol.init(jax.random.PRNGKey(0))
    key = jax.random.PRNGKey(7)
    want_p, want_s = jes.run_fused(params, key, GENS)

    es = _make(optimizer, n)
    draws = iter(_jax_draws(key, GENS, n, es.pairs_per_dev, POLICY.dim))
    pending = []

    def noise():
        eps, states = next(draws)
        pending.append(states)
        return eps

    es._noise = noise
    es.reset_fn = lambda pop, generator: pending.pop()
    got_p, got_s = es.run_fused(torch.from_numpy(np.array(params)), GENS)
    assert not pending and next(draws, None) is None
    want_s = np.asarray(want_s, np.float32)
    assert len(set(want_s[:, 0].tolist())) > 1      # the policy moved
    assert got_s.numpy().tolist() == want_s.tolist()
    assert np.abs(got_p.numpy() - np.asarray(want_p)).max() < 1e-6 * GENS
    if optimizer == "adam":
        assert float(es._opt_state[2]) == float(jes._opt_state[2]) == GENS


def test_run_fused_continues_like_run():
    """Two fused calls carry the optimizer state over as two runs do."""
    fused, eager = _make("adam"), _make("adam")
    p0 = POLICY.init(device="cpu")
    p1, _ = fused.run_fused(p0, 2)
    p2, stats = fused.run_fused(p1, 3)
    q, _ = eager.run(p0, 5)
    assert torch.equal(p2, q) and stats.shape == (3, 3)
    assert float(fused._opt_state[2]) == 5.0


def test_adam_step_count_is_a_tensor():
    es = _make("adam")
    p = POLICY.init(device="cpu")
    for gen in range(1, 4):
        p, _ = es.step(p)
        t = es._opt_state[2]
        assert isinstance(t, torch.Tensor) and t.shape == ()
        assert t.dtype == torch.float32 and t.device == p.device
        assert float(t) == gen
    es.reset_optimizer()
    es.step(p)
    assert float(es._opt_state[2]) == 1.0


def test_apply_es_update_counts_a_tensor_step():
    """A 0-d f32 t advances as a tensor and corrects the bias as the JAX
    update does with its device-scalar t (within 1e-6, as
    ``test_torch_es.py`` holds the update)."""
    rng = np.random.default_rng(5)
    arrays = [rng.standard_normal(20).astype(np.float32) for _ in range(4)]
    arrays[3] = np.abs(arrays[3])
    kw = dict(lr=0.03, wd=0.01, adam=True)
    got = apply_es_update(*(torch.from_numpy(a) for a in arrays),
                          torch.tensor(2.0), **kw)
    want = jax_update(*(jnp.asarray(a) for a in arrays),
                      jnp.asarray(2.0, jnp.float32), **kw)
    assert isinstance(got[3], torch.Tensor) and got[3].shape == ()
    assert float(got[3]) == float(want[3]) == 3.0
    for a, b in zip(got[:3], want[:3]):
        assert np.abs(a.numpy() - np.asarray(b)).max() < 1e-6


def test_mesh_step_calls_eval_fn_once():
    """The 8-rank step evaluates the whole population in one call, and
    rank r's fitness row is its own members' returns, "+" then "-"."""
    calls = []
    es = _make(n=8, eval_calls=calls)
    p = POLICY.init(device="cpu")
    g = torch.Generator().manual_seed(9)
    eps = torch.randn(POP // 2, POLICY.dim, generator=g)
    states = CartPole.reset(POP, g)
    es.step(p, eps=eps, states=states)
    assert calls == [POP]
    k = POP // 16
    assert es.last_fitness.shape == (8, 2 * k)
    for r in (0, 5):
        e = eps[r * k:(r + 1) * k]
        want = CartPole.rollout(
            POLICY.act, torch.cat([p + 0.1 * e, p - 0.1 * e]),
            states[2 * r * k:2 * (r + 1) * k], max_steps=STEPS)
        assert torch.equal(es.last_fitness[r], want)
    calls.clear()
    es.run_fused(p, 2)
    assert calls == [POP, POP]


def test_build_fused_runner_loops_on_the_cpu():
    """The runner over a tuple state: N device steps, stats stacked, and
    a wrong slot count raises."""
    def device_step(x, n):
        return x * 2, n + 1, torch.stack([x.sum(), n])

    run = build_fused_runner(device_step, make_mesh("cpu"), 2, 3)
    x, n, stats = run(torch.ones(2), torch.tensor(0.0))
    assert torch.equal(x, torch.full((2,), 8.0)) and float(n) == 3.0
    assert stats.tolist() == [[2.0, 0.0], [4.0, 1.0], [8.0, 2.0]]
    with pytest.raises(ValueError, match="state slots"):
        run(torch.ones(2))
    with pytest.raises(ValueError, match="generations"):
        build_fused_runner(device_step, make_mesh("cpu"), 2, 0)


def test_build_fused_runner_takes_the_graph_on_cuda():
    """A CUDA mesh gets the CUDA-graph runner, whatever the machine:
    without a card its first call raises, never loops eagerly."""
    run = build_fused_runner(lambda x: (x, x.sum()),
                             Mesh((torch.device("cuda", 0),)), 1, 2)
    assert isinstance(run, es_mod._GraphRunner)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            run(torch.ones(2))


def test_run_steps_drives_a_state_tuple():
    def step(state):
        a, b = state
        return (b, a + b), b

    state, history = run_steps(step, (0, 1), 5)
    assert state == (5, 8) and history == [1, 1, 2, 3, 5]


def test_run_es_returns_params_and_stats():
    params, stats, _ = run_es(device="cpu", pop=16, max_steps=20,
                              generations=3, seed=2)
    assert params.shape == (MLPPolicy(4, 2, (32, 32)).dim,)
    assert stats.shape == (3, 3) and bool(torch.isfinite(stats).all())
    again, stats2, _ = run_es(device="cpu", pop=16, max_steps=20,
                              generations=3, seed=2)
    assert torch.equal(params, again) and torch.equal(stats, stats2)


def test_run_es_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_es(pop=16, max_steps=20, generations=1)
