"""The port's mesh, collectives and ring exchange against the JAX
package's synchronous collectives on the 8-device CPU mesh.

The JAX package's own Pallas DMA ring cannot run on the installed jax
(``tests/test_dma_ring.py`` fails inside it), so ``ring_exchange`` is
held against ``lax.ppermute`` and ``ring_all_to_all`` against
``lax.all_to_all(tiled=True)`` in ``shard_map``, the oracles that test
file uses. The port's rank r is JAX's device r: both cut dim 0 into
contiguous per-rank blocks in order.

Tolerances: rotations and gathers move bits, so they are exact; the
all-to-all within 1e-6 as the JAX suite holds it; sums within 1e-6 (f32
sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from fiber_tpu.ops import collectives as jax_coll
from fiber_tpu.utils.jaxcompat import shard_map

from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.ops.dma_ring import (
    ring_all_to_all,
    ring_exchange,
    ring_exchange_reference,
)
from fiber_tpu_torch.parallel.mesh import Mesh, make_mesh, shard, unshard
from fiber_tpu_torch.utils import flops

N = 8


def _jax_mesh(n=N):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("pool",))


def _np(x):
    return np.asarray(jax.device_get(x))


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _per_device(fn, n_in, n_out=1, n=N):
    spec = P("pool")
    return shard_map(fn, mesh=_jax_mesh(n), in_specs=(spec,) * n_in,
                     out_specs=spec if n_out == 1 else (spec,) * n_out,
                     check_vma=False)


def _ppermute(*arrays):
    perm = [(i, (i + 1) % N) for i in range(N)]

    def body(*blks):
        return tuple(jax.lax.ppermute(b, "pool", perm) for b in blks)

    out = _per_device(body, len(arrays), len(arrays))(
        *(jnp.asarray(a) for a in arrays))
    return [_np(o) for o in out]


# (name, shapes of the arrays rotated together)
EXCHANGES = {
    "one": [(128, 16)],
    "kv_pair": [(128, 4, 8), (128, 4, 8)],
    "three_ragged": [(8 * 13, 3, 5), (8 * 2, 7), (8, 1)],
}


@pytest.mark.parametrize("case", list(EXCHANGES))
def test_ring_exchange_matches_ppermute(case):
    arrays = [_rand(s, seed=i) for i, s in enumerate(EXCHANGES[case])]
    want = _ppermute(*arrays)
    mesh = make_mesh("cpu", n=N)
    got = ring_exchange([shard(torch.from_numpy(a), mesh) for a in arrays],
                        mesh)
    assert len(got) == len(arrays)
    for g, w, a in zip(got, want, arrays):
        np.testing.assert_array_equal(unshard(g, mesh).numpy(), w)
        # and the global picture: rank i's block landed on rank i + 1
        np.testing.assert_array_equal(
            unshard(g, mesh).numpy(), np.roll(a, a.shape[0] // N, axis=0))


def test_ring_exchange_plain_version_is_exact_in_bf16():
    mesh = make_mesh("cpu", n=3)
    x = torch.from_numpy(_rand((12, 5), seed=7)).to(torch.bfloat16)
    (got,) = ring_exchange_reference([shard(x, mesh)], mesh)
    assert all(g.dtype == torch.bfloat16 for g in got)
    assert torch.equal(unshard(got, mesh), torch.roll(x, 4, dims=0))


def test_ring_exchange_single_rank_and_empty_are_noops():
    launches = ring_exchange.launches
    one = make_mesh("cpu")
    x = torch.from_numpy(_rand((32, 8), seed=4))
    ((out,),) = ring_exchange([[x]], one)
    assert out is x
    assert ring_exchange([], make_mesh("cpu", n=N)) == []
    assert ring_all_to_all([x], one, split_axis=1, concat_axis=0) == [x]
    assert ring_exchange.launches == launches


def test_ring_exchange_outputs_do_not_alias_inputs():
    mesh = make_mesh("cpu", n=4)
    k = shard(torch.from_numpy(_rand((16, 2, 3), seed=5)), mesh)
    v = shard(torch.from_numpy(_rand((16, 2, 3), seed=6)), mesh)
    before = [b.clone() for b in k + v]
    ko, vo = ring_exchange([k, v], mesh)
    ptrs = {b.data_ptr() for b in k + v}
    assert not ptrs & {b.data_ptr() for b in ko + vo}
    for b in ko + vo:
        b.fill_(0.0)
    assert all(torch.equal(a, b) for a, b in zip(before, k + v))


def test_ring_exchange_checks_its_inputs():
    mesh = make_mesh("cpu", n=2)
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="blocks for 2 ranks"):
        ring_exchange([[x[:2]]], mesh)
    with pytest.raises(ValueError, match="differs"):
        ring_exchange([[x[:2], x[:1]]], mesh)
    g = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward-only"):
        ring_exchange([[g, g]], mesh)
    with torch.no_grad():
        ring_exchange([[g, g]], mesh)


@pytest.mark.parametrize("split_axis,concat_axis", [(1, 0), (0, 1)])
def test_ring_all_to_all_matches_native(split_axis, concat_axis):
    x = _rand((128, 8, 4), seed=8)

    def native(blk):
        return jax.lax.all_to_all(blk, "pool", split_axis=split_axis,
                                  concat_axis=concat_axis, tiled=True)

    want = _np(_per_device(native, 1)(jnp.asarray(x)))
    mesh = make_mesh("cpu", n=N)
    blocks = shard(torch.from_numpy(x), mesh)
    for engine in (ring_all_to_all, collectives.all_to_all):
        got = unshard(engine(blocks, mesh, split_axis=split_axis,
                             concat_axis=concat_axis), mesh).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_ring_all_to_all_rejects_indivisible_axis():
    mesh = make_mesh("cpu", n=3)
    blocks = shard(torch.zeros(6, 4, 2), mesh)
    for engine in (ring_all_to_all, collectives.all_to_all):
        with pytest.raises(ValueError, match="divide"):
            engine(blocks, mesh, split_axis=1, concat_axis=0)


def test_ppermute_engine_matches_ppermute():
    x = _rand((64, 3), seed=9)
    (want,) = _ppermute(x)
    mesh = make_mesh("cpu", n=N)
    blocks = shard(torch.from_numpy(x), mesh)
    got = collectives.ppermute(blocks, mesh)
    np.testing.assert_array_equal(unshard(got, mesh).numpy(), want)
    assert not {b.data_ptr() for b in blocks} & {b.data_ptr() for b in got}


def test_sharded_collectives_match_jax():
    x = _rand((64, 5), seed=10)
    jmesh, mesh = _jax_mesh(), make_mesh("cpu", n=N)
    t = torch.from_numpy(x)
    for jfn, fn in ((jax_coll.psum_sharded, collectives.psum_sharded),
                    (jax_coll.pmean_sharded, collectives.pmean_sharded)):
        want = _np(jfn(jnp.asarray(x), jmesh))
        np.testing.assert_allclose(fn(shard(t, mesh), mesh).numpy(), want,
                                   rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        collectives.all_gather_sharded(shard(t, mesh), mesh).numpy(),
        _np(jax_coll.all_gather_sharded(jnp.asarray(x), jmesh)))
    copies = collectives.broadcast_to_mesh(x, mesh)
    assert len(copies) == N
    want = _np(jax_coll.broadcast_to_mesh(x, jmesh))
    for c in copies:
        np.testing.assert_array_equal(c.numpy(), want)
    assert len({c.data_ptr() for c in copies}) == N


def test_per_rank_collectives_match_jax():
    x = _rand((N, 6), seed=11)
    mesh = make_mesh("cpu", n=N)

    def body(blk):
        v = blk[0]
        return jnp.stack([jax.lax.psum(v, "pool"), jax.lax.pmean(v, "pool")]
                         )[None], jax.lax.all_gather(v, "pool")[None]

    sums, gathered = _per_device(body, 1, 2)(jnp.asarray(x))
    per_rank = list(torch.from_numpy(x))
    np.testing.assert_allclose(collectives.psum(per_rank, mesh).numpy(),
                               _np(sums)[0, 0], rtol=0, atol=1e-6)
    np.testing.assert_allclose(collectives.pmean(per_rank, mesh).numpy(),
                               _np(sums)[0, 1], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        collectives.all_gather(per_rank, mesh).numpy(), _np(gathered)[0])


def test_shard_makes_contiguous_blocks_and_round_trips():
    mesh = make_mesh("cpu", n=4)
    qkv = torch.from_numpy(_rand((16, 9), seed=12))
    q = torch.chunk(qkv, 3, dim=-1)[1]           # a strided view
    blocks = shard(q, mesh)
    assert [b.shape for b in blocks] == [(4, 3)] * 4
    assert all(b.is_contiguous() for b in blocks)
    assert torch.equal(unshard(blocks, mesh), q)
    with pytest.raises(ValueError, match="divisible"):
        shard(torch.zeros(6, 2), mesh)
    with pytest.raises(ValueError, match="ranks"):
        unshard(blocks[:3], mesh)


def test_mesh_over_several_cuda_devices_raises():
    mesh = make_mesh("cpu", n=8)
    assert mesh.n_dev == 8 and mesh.axis == "pool"
    with pytest.raises(NotImplementedError, match="A.7"):
        Mesh((torch.device("cuda", 0), torch.device("cuda", 1)))
    with pytest.raises(ValueError, match="one device type"):
        Mesh((torch.device("cpu"), torch.device("cuda", 0)))
    with pytest.raises(ValueError):
        make_mesh("cpu", n=0)


def test_ring_exchange_bytes_counts_each_block_twice():
    mesh = make_mesh("cpu", n=4)
    k = shard(torch.zeros(16, 2, 3), mesh)
    v = shard(torch.zeros(16, 2, 3, dtype=torch.bfloat16), mesh)
    assert flops.ring_exchange_bytes([k, v]) == 2 * (16 * 6 * 4 + 16 * 6 * 2)
