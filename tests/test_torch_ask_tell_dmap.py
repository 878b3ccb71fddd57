"""The port's AskTellES and device_map/DeviceMapPlan against the JAX
package on the same inputs, on the CPU.

``AskTellES.ask`` is handed the noise that the JAX ``ask(key)`` draws
(``normal(key, (pairs, dim))``): the candidates must be the JAX ones
within 1e-6, and ``tell`` with the same fitnesses must leave the same
params within 1e-6 a generation, SGD and Adam, over 3 generations (the
mean and max fitness it reports within 1e-6 relative: an f32 mean
summed in another order).
``device_map`` maps a function written twice, once in jnp and once in
torch, over the same items on 1 and 8 ranks: results within 1e-6 (the
same f32 arithmetic per item), in order, of the same types and shapes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fiber_tpu.ops import AskTellES as JaxAskTellES
from fiber_tpu.parallel import DeviceMapPlan as JaxDeviceMapPlan
from fiber_tpu.parallel import device_map as jax_device_map

from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops.es import AskTellES, EvolutionStrategy
from fiber_tpu_torch.parallel.dmap import DeviceMapPlan, device_map
from fiber_tpu_torch.parallel.mesh import make_mesh

TOL = 1e-6


def _np(x):
    return np.asarray(jax.device_get(x))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs(got.astype(np.float64) - want).max(initial=0) <= tol


def _fitness(thetas):
    """A host evaluator: a rugged quadratic, on numpy rows."""
    target = np.linspace(-1, 1, thetas.shape[1], dtype=np.float32)
    return -((thetas - target) ** 2).sum(1) + 0.1 * np.sin(5 * thetas).sum(1)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_ask_tell_matches_jax_over_three_generations(optimizer):
    dim, pop = 12, 20
    params0 = np.random.default_rng(0).standard_normal(dim).astype(
        np.float32)
    kw = dict(sigma=0.2, lr=0.05, weight_decay=0.01, optimizer=optimizer,
              params0=params0)
    jes = JaxAskTellES(dim, pop, **kw)
    es = AskTellES(dim, pop, device="cpu", **kw)
    assert es.pop_size == jes.pop_size == 20
    key = jax.random.PRNGKey(3)
    for gen in range(3):
        key, sub = jax.random.split(key)
        want = jes.ask(sub)
        got = es.ask(eps=np.array(jax.random.normal(sub, (es.pairs, dim))))
        assert isinstance(got, np.ndarray)
        _close(got, want, TOL * (gen + 1))
        fits = _fitness(want)
        want_stats, got_stats = jes.tell(fits), es.tell(fits)
        assert got_stats == pytest.approx(want_stats, rel=1e-6)
        _close(es.params.numpy(), _np(jes.params), TOL * (gen + 1))
    assert float(es._t) == (3.0 if optimizer == "adam" else 0.0)
    assert es._t.dim() == 0 and torch.is_tensor(es._t)


def test_ask_tell_draws_from_its_generator_and_learns():
    """The loop of ``es_pool_gym.py`` on a host objective: drawn noise
    from the generator (seed 0 by default), the mean fitness rising."""
    es = AskTellES(4, 64, sigma=0.5, lr=0.3, device="cpu")
    again = AskTellES(4, 64, sigma=0.5, lr=0.3, device="cpu")
    means = []
    for _ in range(15):
        thetas = es.ask()
        assert np.array_equal(thetas, again.ask())
        assert thetas.shape == (64, 4) and thetas.dtype == np.float32
        means.append(es.tell(_fitness(thetas))["mean_fitness"])
        again.tell(_fitness(thetas))
    assert means[-1] > means[0] + 0.5


@pytest.mark.parametrize("case", ["ask_twice", "tell_first", "count",
                                  "params0", "pop", "optimizer", "eps"])
def test_ask_tell_errors_match_jax(case):
    """Each misuse raises the JAX package's error, with its message."""
    def run(cls, **dev):
        if case == "params0":
            return cls(4, 8, params0=np.zeros(3), **dev)
        if case == "pop":
            return cls(4, 1, **dev)
        if case == "optimizer":
            return cls(4, 8, optimizer="rmsprop", **dev)
        es = cls(4, 8, **dev)
        if case == "tell_first":
            return es.tell(np.zeros(8))
        if cls is AskTellES:
            if case == "eps":
                return es.ask(eps=np.zeros((3, 4)))
            es.ask()
        else:
            es.ask(jax.random.PRNGKey(0))
        if case == "ask_twice":
            return es.ask() if cls is AskTellES else es.ask(
                jax.random.PRNGKey(1))
        return es.tell(np.zeros(7))

    if case == "eps":          # the port's own: a wrong noise shape
        with pytest.raises(ValueError, match="eps shape"):
            run(AskTellES, device="cpu")
        return
    with pytest.raises(Exception) as want:
        run(JaxAskTellES)
    with pytest.raises(want.type) as got:
        run(AskTellES, device="cpu")
    head = str(want.value).split("(")[0].split("!=")[0]
    assert str(got.value).startswith(head.strip()[:12])


# -- device_map ---------------------------------------------------------

def _meshes(n):
    return (JaxMesh(np.asarray(jax.devices()[:n]), ("pool",)),
            make_mesh("cpu", n=n))


def _same(got, want):
    """Two host results: the same pytree of numpy values."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    else:
        assert type(got) is type(want), (type(got), type(want))
        _close(got, want)


def _items(kind, count, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "scalar":
        return [float(x) for x in rng.standard_normal(count)]
    if kind == "array":
        return list(rng.standard_normal((count, 3)).astype(np.float32))
    if kind == "pytree":
        return [{"a": rng.standard_normal(2).astype(np.float32),
                 "b": (rng.standard_normal(3).astype(np.float32),
                       np.float32(rng.standard_normal()))}
                for _ in range(count)]
    if kind == "star":
        return [(rng.standard_normal(3).astype(np.float32),
                 np.float32(rng.standard_normal())) for _ in range(count)]
    raise ValueError(kind)


FNS = {
    "scalar": (lambda x: x * 2.0 + 1.0, lambda x: x * 2.0 + 1.0),
    "array": (lambda a: jnp.sum(a) * a, lambda a: torch.sum(a) * a),
    "pytree": (lambda t: {"s": jnp.sum(t["a"])
                          + jnp.sum(t["b"][0]) * t["b"][1],
                          "v": (t["a"] * 2.0, t["b"][0] - t["b"][1])},
               lambda t: {"s": torch.sum(t["a"]) + torch.sum(t["b"][0])
                          * t["b"][1],
                          "v": (t["a"] * 2.0, t["b"][0] - t["b"][1])}),
    "star": (lambda x, y: x * y + y, lambda x, y: x * y + y),
}


@pytest.mark.parametrize("n", [1, 8])
@pytest.mark.parametrize("kind", list(FNS))
def test_device_map_matches_jax(kind, n):
    """13 items: on 8 ranks the batch pads to 16 by repeating the last
    item, and only the 13 come back, in order."""
    jmesh, mesh = _meshes(n)
    items = _items(kind, 13)
    jfn, tfn = FNS[kind]
    star = kind == "star"
    want = jax_device_map(jfn, items, mesh=jmesh, star=star)
    got = device_map(tfn, items, mesh=mesh, star=star)
    assert len(got) == len(want) == 13
    for g, w in zip(got, want):
        _same(g, w)


@pytest.mark.parametrize("n", [1, 8])
def test_device_map_broadcast_matches_jax(n):
    """A shared weight passed once at position 1, unbatched."""
    jmesh, mesh = _meshes(n)
    rng = np.random.default_rng(5)
    w = rng.standard_normal((3, 2)).astype(np.float32)
    items = [(rng.standard_normal(3).astype(np.float32),
              rng.standard_normal(2).astype(np.float32)) for _ in range(13)]
    want = jax_device_map(lambda x, w, y: x @ w + y, items, mesh=jmesh,
                          star=True, broadcast=(w,), broadcast_positions=(1,))
    got = device_map(lambda x, w, y: x @ w + y, items, mesh=mesh, star=True,
                     broadcast=(w,), broadcast_positions=(1,))
    for g, v in zip(got, want):
        _same(g, v)
    with pytest.raises(ValueError, match="pair up"):
        DeviceMapPlan(lambda x: x, mesh=mesh, star=True, broadcast=(w,))
    with pytest.raises(ValueError, match="star=True"):
        DeviceMapPlan(lambda x: x, mesh=mesh, broadcast=(w,),
                      broadcast_positions=(0,))


def test_device_map_plan_is_reused_and_takes_batches():
    """One plan, three calls: a list, another list of another length, a
    numpy batch; each equals the JAX plan's."""
    jmesh, mesh = _meshes(8)
    jplan = JaxDeviceMapPlan(lambda a: jnp.sum(a) * a, mesh=jmesh)
    plan = DeviceMapPlan(lambda a: torch.sum(a) * a, mesh=mesh, donate=True)
    mapped = plan._mapped
    for items in (_items("array", 5), _items("array", 17, seed=1),
                  np.stack(_items("array", 9, seed=2))):
        got, want = plan(items), jplan(items)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    assert plan._mapped is mapped


def test_empty_map_resolves_no_device(monkeypatch):
    """An empty map returns [] before any device is resolved: with no
    mesh and no device named, it would otherwise ask for CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert device_map(lambda x: x, []) == []
    assert device_map(lambda x: x, iter(())) == []
    assert jax_device_map(lambda x: x, []) == []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_map(lambda x: x, [1.0])


def test_device_map_of_cartpole_rollouts_equals_the_batched_returns():
    """A per-item CartPole evaluation, (theta, state) pairs on 4 ranks:
    the returns of ``EvolutionStrategy``'s batched evaluation of the same
    rows, exactly (the rollout writes nothing in place, so vmap can map
    it; a batched matmul of the same shape)."""
    pol = MLPPolicy(4, 2, hidden=(8,))
    g = torch.Generator().manual_seed(0)
    thetas = pol.init(g, device="cpu") + 0.5 * torch.randn(30, pol.dim,
                                                           generator=g)
    states = CartPole.reset(30, g)

    def rollout(theta, state):
        return CartPole.rollout(pol.act, theta[None], state[None],
                                max_steps=60)[0]

    got = device_map(rollout, list(zip(thetas, states)), star=True,
                     mesh=make_mesh("cpu", n=4))
    es = EvolutionStrategy(
        lambda th, st: CartPole.rollout(pol.act, th, st, max_steps=60),
        CartPole.reset, dim=pol.dim, pop_size=30, device="cpu")
    want = es.eval_fn(thetas, states)
    assert [float(x) for x in got] == want.tolist()
    assert len(set(want.tolist())) > 3
