"""The port's POET against the JAX package's on the same draws, on the
CPU.

Random draws differ between the two (threefry vs Philox), so the JAX
POET runs first with every draw it takes recorded where it is derived
from a key: each ES step's noise and initial states as
``EvolutionStrategy.step`` derives them (``fold_in(key, device)`` split
into the noise key and the evaluation key, for each device of the
mesh: one device, or the default mesh over the suite's 8 virtual
devices against the port on 8 ranks), the minimal criterion's and the
proposal's initial state (``reset`` of the key handed to
``_eval_pair``), the transfer matrix's
states (``reset`` of each agent's key handed to ``_cross``), the parent
pick (``jax.random.randint``) and the mutation noise (``normal(key,
(4,))``). The port then takes those draws, each kind in its order,
through its draw methods; every recorded draw must be used.

Tolerances: histories equal (their counts exactly, the mean fitness as
the same f32 means of integer returns); environments and the archive
exactly (the same f32 mutation of the same noise); agents within 1e-5
(ES updates in f32 summed in another order, 1e-6 a step). Returns are
integers decided by f32 physics on parameters 1e-6 apart: a return
that a near-tie could flip would show as unequal histories, and none
does on these draws.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.models import ParamCartPole as JaxParamCartPole
from fiber_tpu.ops.poet import POET as JaxPOET

from fiber_tpu_torch.entry import make_poet, run_poet
from fiber_tpu_torch.models.convert import poet_state_from_jax
from fiber_tpu_torch.models.envs import ParamCartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops.poet import POET
from fiber_tpu_torch.parallel.mesh import Mesh as TorchMesh, make_mesh

HIDDEN = (16,)


def _np(x):
    return np.asarray(jax.device_get(x))


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _jax_poet(monkeypatch, pop=32, steps=60, max_pairs=3, parents=None,
              noises=None, default_mesh=False, **kw):
    """A JAX POET on a one-device mesh (with ``default_mesh``, on the
    default mesh over all 8 devices) whose every draw is recorded in
    ``draws``; ``parents`` and ``noises``, when given, replace the parent
    picks and mutation draws (and are recorded as such)."""
    draws = {"es": [], "reset": [], "parent": [], "mutation": []}

    class Env(JaxParamCartPole):
        @classmethod
        def mutate(cls, env_params, key, scale=0.15):
            noise = (jnp.asarray(noises.pop(0), jnp.float32) if noises
                     else jax.random.normal(key, (4,)))
            draws["mutation"].append(_np(noise))
            with mock.patch.object(jax.random, "normal",
                                   lambda k, shape: noise):
                return super().mutate(env_params, key, scale)

    real_randint = jax.random.randint

    def randint(key, shape, minval, maxval, *a, **k):
        out = (jnp.asarray(parents.pop(0), jnp.int32) if parents
               else real_randint(key, shape, minval, maxval, *a, **k))
        draws["parent"].append(int(out))
        return out

    monkeypatch.setattr(jax.random, "randint", randint)
    jpol = JaxMLPPolicy(4, 2, hidden=HIDDEN)
    mesh = (None if default_mesh
            else Mesh(np.asarray(jax.devices()[:1]), ("pool",)))
    jp = JaxPOET(Env, jpol, pop_size=pop, max_pairs=max_pairs,
                 rollout_steps=steps, mesh=mesh, **kw)
    es = jp._get_es()
    es_step, eval_pair, cross = es.step, jp._eval_pair, jp._cross

    def rec_step(params, key):
        # every device's own draws (fold_in(key, device)), rank-major
        eps, states = [], []
        for dev in range(es.n_dev):
            eps_key, eval_key = jax.random.split(jax.random.fold_in(key,
                                                                    dev))
            eps.append(_np(jax.random.normal(
                eps_key, (es.pairs_per_dev, es.dim))))
            states.append(_np(jax.vmap(Env.reset)(jax.random.split(
                eval_key, 2 * es.pairs_per_dev))))
        draws["es"].append((np.concatenate(eps), np.concatenate(states)))
        return es_step(params, key)

    def rec_eval(env, theta, key):
        if not isinstance(key, jax.core.Tracer):   # the ES's trace passes
            draws["reset"].append(_np(Env.reset(key))[None])
        return eval_pair(env, theta, key)

    def rec_cross(envs, agents, keys):
        draws["reset"].append(_np(jax.vmap(Env.reset)(keys)))
        return cross(envs, agents, keys)

    es.step, jp._eval_pair, jp._cross = rec_step, rec_eval, rec_cross
    return jp, draws


def _port_like(jp, ranks=1):
    """The port's POET on ``ranks`` CPU ranks, in ``jp``'s current
    state."""
    poet = POET(ParamCartPole, MLPPolicy(4, 2, hidden=HIDDEN),
                pop_size=jp.pop_size, max_pairs=jp.max_pairs,
                rollout_steps=jp.rollout_steps, mc_low=jp.mc_low,
                mc_high=jp.mc_high, mesh=make_mesh("cpu", n=ranks))
    poet.envs, poet.agents, poet.archive = poet_state_from_jax(
        [_np(e) for e in jp.envs], [_np(a) for a in jp.agents], jp.archive,
        device="cpu")
    return poet


def _feed(poet, draws):
    """Points ``poet``'s draw methods at ``draws``, each kind in its
    order. Returns the queues, which a run must empty."""
    q = {k: list(v) for k, v in draws.items()}
    pending = []

    def noise():
        eps, states = q["es"].pop(0)
        pending.append(states)
        return _t(eps)

    def reset(n):
        states = q["reset"].pop(0)
        assert states.shape[0] == n
        return _t(states)

    poet._es._noise = noise
    poet._es.reset_fn = lambda n, g: _t(pending.pop())
    poet._reset = reset
    poet._pick_parent = lambda n: q["parent"].pop(0)
    poet._mutation_noise = lambda: _t(q["mutation"].pop(0))
    return q


def _assert_same_population(poet, jp, agent_tol=1e-5):
    assert len(poet.envs) == len(jp.envs) == len(poet.agents)
    for e, je in zip(poet.envs, jp.envs):
        assert e.numpy().tolist() == _np(je).tolist()
    for a, ja in zip(poet.agents, jp.agents):
        assert np.abs(a.numpy() - _np(ja)).max() < agent_tol
    assert len(poet.archive) == len(jp.archive)
    for a, ja in zip(poet.archive, jp.archive):
        assert a.dtype == np.float64 and a.tolist() == ja.tolist()


def test_novelty_matches_jax(monkeypatch):
    """Mean distance to the k nearest archived envs, on archives shorter
    and longer than k, including a candidate equidistant from two."""
    jp, _ = _jax_poet(monkeypatch)
    poet = POET(ParamCartPole, MLPPolicy(4, 2, hidden=HIDDEN), device="cpu")
    rng = np.random.default_rng(0)
    cands = [np.asarray(ParamCartPole.DEFAULT, np.float32)] + [
        rng.uniform(ParamCartPole.PARAM_LOW, ParamCartPole.PARAM_HIGH
                    ).astype(np.float32) for _ in range(6)]
    for n_archive in (1, 2, 5):
        extra = [np.asarray(c, dtype=float) for c in cands[1:n_archive]]
        jp.archive = jp.archive[:1] + extra
        poet.archive = poet.archive[:1] + extra
        for c in cands:
            assert poet.novelty(_t(c)) == jp.novelty(jnp.asarray(c))
    poet.archive = [np.asarray(ParamCartPole.DEFAULT, dtype=float)]
    assert poet.novelty(ParamCartPole.DEFAULT) == 0.0
    # k = 3 over an archive of two: the mean of both distances
    poet.archive = [np.zeros(4), np.full(4, 2.0)]
    assert poet.novelty(torch.ones(4)) == 2.0


def test_try_spawn_envs_tie_and_eviction_match_jax(monkeypatch):
    """Two candidates clipped to the same corner of the parameter box
    (from parents 0 and 1) tie on novelty: the larger index wins, as in
    JAX's ``max`` over (novelty, index), so parent 1's agent comes with
    it. At capacity (2 pairs) each admission retires the oldest pair,
    whose env stays in the archive."""
    jp, draws = _jax_poet(
        monkeypatch, max_pairs=2, mc_low=0.0, mc_high=60.0,
        parents=[0, 1, 0, 1],
        noises=[np.full(4, 40.0), np.full(4, 40.0), np.full(4, 0.5),
                np.full(4, -40.0)])
    e1 = jnp.asarray(ParamCartPole.DEFAULT) + jnp.asarray(
        [0.3, 0.05, -0.4, 0.01])
    jp.envs.append(e1)
    jp.agents.append(jp.agents[0] + 0.1 * jax.random.normal(
        jax.random.PRNGKey(8), jp.agents[0].shape))
    jp.archive.append(np.asarray(e1, dtype=float))
    poet = _port_like(jp)
    parent1 = poet.agents[1]
    want = jp.try_spawn_envs(jax.random.PRNGKey(3))
    q = _feed(poet, draws)
    assert poet.try_spawn_envs() == want == 2
    assert not any(q.values())
    _assert_same_population(poet, jp)
    high = torch.tensor(ParamCartPole.PARAM_HIGH)
    assert torch.equal(poet.envs[0], high)          # the tie's winner...
    assert poet.agents[0] is parent1                # ...is parent 1's
    assert len(poet.archive) == 4 and len(poet.envs) == 2


@pytest.mark.parametrize("proposal_steps", [0, 1])
def test_transfer_matches_jax(monkeypatch, proposal_steps):
    """Three pairs whose first agent always pushes left: the matrix
    (one initial state an agent, shared across envs), the direct and
    proposal stages and the adoptions match JAX's."""
    jp, draws = _jax_poet(monkeypatch)
    rng = np.random.default_rng(1)
    for i in range(2):
        jp.envs.append(jnp.asarray(rng.uniform(
            ParamCartPole.PARAM_LOW, [12.0, 0.8, 12.0, 0.2]), jnp.float32))
        jp.agents.append(jp.agents[0] + 0.2 * jax.random.normal(
            jax.random.PRNGKey(20 + i), jp.agents[0].shape))
    jp.agents[0] = jnp.zeros_like(jp.agents[0])
    poet = _port_like(jp)
    want = jp.transfer(jax.random.PRNGKey(5), proposal_steps=proposal_steps)
    q = _feed(poet, draws)
    assert poet.transfer(proposal_steps=proposal_steps) == want >= 1
    assert poet.last_transfer_evals == jp.last_transfer_evals
    assert (jp.last_transfer_evals > 0) == (proposal_steps > 0)
    assert not any(q.values())
    _assert_same_population(poet, jp)


def test_run_matches_jax(monkeypatch):
    """Two iterations of the whole loop at pop 32, 60 steps and 3 pairs:
    the same histories, environments, archive and agents."""
    jp, draws = _jax_poet(monkeypatch)
    poet = _port_like(jp)
    want = jp.run(jax.random.PRNGKey(0), 2, es_steps=4)
    q = _feed(poet, draws)
    got = poet.run(2, es_steps=4)
    assert got == want
    assert not any(q.values())
    _assert_same_population(poet, jp)
    assert sum(h["spawned"] for h in got) > 0    # the loop really ran
    assert len(draws["es"]) > 8


def test_run_over_8_ranks_matches_jax_default_mesh(monkeypatch):
    """Two iterations at pop 64 on 8 ranks against the JAX POET on its
    default mesh over the 8 virtual devices: every ES step takes each
    device's own noise and initial states, rank-major, so the members,
    their gathered fitness and the tie order are JAX's. The same
    histories, environments and archive; agents within the 1-rank
    test's 1e-5. (About 10 s: the JAX POET compiles its 8-device step.)"""
    jp, draws = _jax_poet(monkeypatch, pop=64, default_mesh=True)
    assert jp._get_es().n_dev == 8
    poet = _port_like(jp, ranks=8)
    assert poet._es.mesh.n_dev == 8 and poet.pop_size == jp.pop_size
    want = jp.run(jax.random.PRNGKey(0), 2, es_steps=4)
    q = _feed(poet, draws)
    got = poet.run(2, es_steps=4)
    assert got == want
    assert not any(q.values())
    _assert_same_population(poet, jp)
    assert sum(h["spawned"] for h in got) > 0
    assert poet._es.last_fitness.shape == (8, 8)


def test_make_poet_spreads_the_es_over_ranks():
    """``ranks=`` builds the mesh that every pair's ES step runs on; the
    fine-tune sees the whole [theta, env] vector and pins the tail."""
    poet = make_poet(device="cpu", pop=16, max_steps=20, ranks=4)
    assert poet.mesh.n_dev == 4 and poet._es.mesh is poet.mesh
    assert poet._es.pairs_per_dev == 2
    env = poet.envs[0]
    combined, stats = poet._pinned_step(torch.cat([poet.agents[0], env]))
    assert torch.equal(combined[poet.policy.dim:], env)
    assert poet._es.last_fitness.shape == (4, 4)
    with pytest.raises(ValueError, match="not the mesh's device"):
        POET(ParamCartPole, poet.policy, device="cpu",
             mesh=TorchMesh((torch.device("cuda", 0),)))


def test_finetune_pins_the_env_tail():
    """ES perturbs the env tail (the members see perturbed physics), and
    every step pins it back."""
    poet = make_poet(device="cpu", pop=16, max_steps=30)
    env = poet.envs[0]
    seen = []
    members = poet._eval_members

    def spy(thetas, states):
        seen.append(thetas[:, poet.policy.dim:].clone())
        return members(thetas, states)

    poet._es.eval_fn = spy
    theta, stats = poet._finetune(poet.agents[0], env, 2)
    assert len(seen) == 2 and stats.shape == (3,)
    assert (seen[0] - env).abs().max() > 1e-3
    assert theta.shape == (poet.policy.dim,)
    assert not torch.equal(theta, poet.agents[0])
    combined, _ = poet._pinned_step(torch.cat([theta, env]))
    assert torch.equal(combined[poet.policy.dim:], env)


def test_run_poet_counts_evals_as_bench():
    history, evals, perf = run_poet(device="cpu", pop=16, max_steps=30,
                                    iterations=2, es_steps=2, max_pairs=3)
    assert [h["iteration"] for h in history] == [0, 1]
    assert evals == sum(h["pairs"] * 16 * 2 + h["transfer_evals"]
                        for h in history)
    assert all(np.isfinite(h["mean_fitness"]) for h in history)
    assert perf["evals_per_sec"] == evals / perf["seconds"]
    assert perf["mfu"] is None and perf["device_kind"] == "cpu"
