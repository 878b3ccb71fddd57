"""The port's checkpoints (``fiber_tpu_torch.utils.checkpoint``) on the
CPU: the round trip, ES and POET runs resumed from a file against the
uninterrupted runs (bit for bit: the same operations on the same
values and generator states), and files crossing between the two
packages with equal leaves."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fiber_tpu.utils import checkpoint as jax_checkpoint

from fiber_tpu_torch.entry import make_poet
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.ops.es import EvolutionStrategy
from fiber_tpu_torch.utils import checkpoint


def _tree():
    g = torch.Generator().manual_seed(0)
    return {
        "w": torch.randn(5, 3, generator=g),
        "w64": torch.randn(4, generator=g, dtype=torch.float64),
        "nested": {"ids": torch.arange(6, dtype=torch.int32),
                   "mask": torch.tensor([True, False]),
                   "n": 7, "none": None},
        "seq": [np.ones((2, 2)), (torch.zeros(()), np.int64(3))],
        "gen": torch.Generator().manual_seed(5),
    }


def test_round_trip(tmp_path):
    """Every leaf kind comes back with its dtype and values; containers
    keep their types; a generator comes back as its state."""
    tree = _tree()
    path = str(tmp_path / "sub" / "ckpt.npz")
    checkpoint.save(path, tree)
    got = checkpoint.load(path)
    assert got["w"].dtype == np.float32
    assert np.array_equal(got["w"], tree["w"].numpy())
    assert got["w64"].dtype == np.float64
    assert np.array_equal(got["nested"]["ids"], np.arange(6, dtype=np.int32))
    assert got["nested"]["mask"].tolist() == [True, False]
    assert int(got["nested"]["n"]) == 7 and got["nested"]["none"] is None
    assert isinstance(got["seq"], list) and isinstance(got["seq"][1], tuple)
    assert np.array_equal(got["gen"], tree["gen"].get_state().numpy())
    on_cpu = checkpoint.load(path, device="cpu")
    assert torch.equal(on_cpu["w"], tree["w"])
    assert on_cpu["nested"]["ids"].dtype == torch.int32
    # the write is atomic: no temporary file stays beside it
    assert sorted(p.name for p in (tmp_path / "sub").iterdir()) == [
        "ckpt.npz"]


def test_bfloat16_raises(tmp_path):
    path = str(tmp_path / "bf16.npz")
    with pytest.raises(TypeError, match="bfloat16"):
        checkpoint.save(path, {"w": torch.ones(3, dtype=torch.bfloat16)})
    assert not (tmp_path / "bf16.npz").exists()


def test_jax_file_loads_in_the_port(tmp_path):
    """A file of ``fiber_tpu.utils.checkpoint.save`` (JAX arrays, numpy
    leaves, nested containers) loads in the port with equal leaves."""
    tree = {"w": jnp.arange(10.0), "k": jax.random.PRNGKey(3),
            "nested": {"b": np.ones((3, 3)), "n": np.asarray(7)},
            "seq": [jnp.zeros((2,), jnp.int32), (np.float64(1.5),)]}
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save(path, tree)
    got = checkpoint.load(path)
    want = jax_checkpoint.load(path)
    for a, b in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert isinstance(got["seq"][1], tuple)
    t = checkpoint.load(path, device="cpu")
    assert torch.equal(t["w"], torch.arange(10.0))


def test_port_file_loads_in_jax(tmp_path):
    """A port file loads with the JAX package's ``load``, leaf for leaf;
    its ES state with the JAX ``load_es_state``."""
    tree = {k: v for k, v in _tree().items() if k != "gen"}
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, tree)
    want = checkpoint.load(path)
    got = jax_checkpoint.load(path)
    leaves = jax.tree_util.tree_leaves(got)
    assert len(leaves) == len(jax.tree_util.tree_leaves(want)) == 8
    for a, b in zip(leaves, jax.tree_util.tree_leaves(want)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    es_path = str(tmp_path / "es.npz")
    g = torch.Generator().manual_seed(1)
    checkpoint.save_es_state(es_path, torch.ones(4), g, generation=3)
    params, key, gen, extra = jax_checkpoint.load_es_state(es_path)
    assert np.array_equal(params, np.ones(4, np.float32)) and gen == 3
    assert np.array_equal(key, g.get_state().numpy())


def _adam_es(seed):
    policy = MLPPolicy(4, 2, hidden=(8,))
    es = EvolutionStrategy(
        lambda th, st: CartPole.rollout(policy.act, th, st, max_steps=40),
        CartPole.reset, dim=policy.dim, pop_size=32, sigma=0.1, lr=0.03,
        optimizer="adam", device="cpu",
        generator=torch.Generator().manual_seed(seed))
    return es, policy.init(torch.Generator().manual_seed(0), device="cpu")


def test_es_resumed_from_a_file_equals_the_uninterrupted_run(tmp_path):
    """Two generations, a checkpoint (params, the generator, Adam's (m,
    v, t) in ``extra``), a fresh strategy with another seed restored
    from it, two more generations: params, stats, Adam's state and the
    generator equal four generations in one run, bit for bit."""
    es, p0 = _adam_es(seed=1)
    p2, s2 = es.run_fused(p0, 2)
    path = str(tmp_path / "es.npz")
    checkpoint.save_es_state(path, p2, es.generator, generation=2,
                             extra=es._opt_state)

    fresh, _ = _adam_es(seed=99)
    params, key, gen, extra = checkpoint.load_es_state(path, device="cpu")
    assert gen == 2 and isinstance(extra, tuple) and extra[2].dim() == 0
    fresh.generator.set_state(key)
    fresh._opt_state = extra
    p4, s4 = fresh.run_fused(params, 2)

    whole, _ = _adam_es(seed=1)
    want_p, want_s = whole.run_fused(p0, 4)
    assert torch.equal(p4, want_p)
    assert torch.equal(torch.cat([s2, s4]), want_s)
    assert all(torch.equal(a, b) for a, b in zip(fresh._opt_state,
                                                 whole._opt_state))
    assert float(fresh._opt_state[2]) == 4.0
    assert torch.equal(fresh.generator.get_state(),
                       whole.generator.get_state())


def test_poet_resumed_from_a_file_equals_the_uninterrupted_run(tmp_path):
    """One POET iteration, a checkpoint, a fresh POET of another seed
    restored from it and one more iteration, against two iterations in
    one run: the second record (all but its index), the pairs, the
    archive and both generators equal, bit for bit."""
    kw = dict(device="cpu", pop=16, max_steps=30, max_pairs=3)
    poet = make_poet(seed=0, **kw)
    first = poet.run(1, es_steps=2)
    path = str(tmp_path / "poet.npz")
    checkpoint.save_poet_state(path, poet, iteration=1)

    fresh = make_poet(seed=7, **kw)
    key, it = checkpoint.load_poet_state(path, fresh)
    assert it == 1 and len(key) == 2
    second = fresh.run(1, es_steps=2)

    whole = make_poet(seed=0, **kw)
    want = whole.run(2, es_steps=2)
    assert want[0] == first[0]
    drop = lambda h: {k: v for k, v in h.items() if k != "iteration"}
    assert drop(second[0]) == drop(want[1])
    assert sum(h["spawned"] for h in want) > 0     # the loop did work
    for got, ref in ((fresh.envs, whole.envs), (fresh.agents, whole.agents)):
        assert len(got) == len(ref)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert [a.tolist() for a in fresh.archive] == [
        a.tolist() for a in whole.archive]
    assert all(a.dtype == np.float64 for a in fresh.archive)
    assert torch.equal(fresh.generator.get_state(),
                       whole.generator.get_state())
    assert torch.equal(fresh.pick_generator.get_state(),
                       whole.pick_generator.get_state())
