"""The port's grid mesh and its data x sequence attention on the CPU:
mesh specs parsed as the JAX package's ``mesh_from_config`` parses them,
the grid's rank layout, and ring and Ulysses attention on a 2 x 4
``("data", "seq")`` mesh against the JAX package's own composition
(``__graft_entry__.py``: the per-device body ``vmap``-ped over the
local batch inside a ``shard_map`` over the grid, on the suite's 8
virtual devices) and against ``reference_attention`` per batch element.

Tolerance 2e-5, the JAX package's for this composition: the same f32
online softmax in another summation order.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh, PartitionSpec as P

from fiber_tpu import config as jax_config
from fiber_tpu.ops import ring_attention_local as jax_ring_local
from fiber_tpu.ops import ulysses_attention_local as jax_ulysses_local
from fiber_tpu.parallel import mesh as jax_mesh
from fiber_tpu.utils.jaxcompat import shard_map

from fiber_tpu_torch.ops.flash_attention import flash_attention
from fiber_tpu_torch.ops.ring_attention import (
    reference_attention,
    ring_attention,
)
from fiber_tpu_torch.ops.ulysses_attention import ulysses_attention
from fiber_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_shape,
    shard,
    shard_grid,
    unshard_grid,
)

TOL = 2e-5
GRID = (2, 4)
B, S, H, D = 4, 32, 4, 8


@pytest.mark.parametrize("spec", ["4x2", "8", "2x2x2", "2X4"])
def test_mesh_shape_matches_mesh_from_config(spec, monkeypatch):
    monkeypatch.setattr(jax_config, "get",
                        lambda: types.SimpleNamespace(mesh_shape=spec))
    assert mesh_shape(spec) == jax_mesh.mesh_from_config()
    shape, names = mesh_shape(spec)
    mesh = make_mesh("cpu", shape=shape)
    assert mesh.names == names and mesh.shape == shape


def test_grid_layout_and_sub_meshes():
    """Rank ``i*s + j`` holds block (i, j); each ``seq`` sub-mesh is a
    data row, each ``data`` sub-mesh a column; a 1-D mesh is as
    before."""
    mesh = make_mesh("cpu", shape=GRID, names=("data", "seq"))
    assert (mesh.n_dev, mesh.axis, mesh.axis_size("seq")) == (8, "data", 4)
    rows, cols = mesh.sub_meshes("seq"), mesh.sub_meshes("data")
    assert [(m.n_dev, m.names) for m in rows] == [(4, ("seq",))] * 2
    assert [(m.n_dev, m.axis) for m in cols] == [(2, "data")] * 4
    x = torch.arange(4 * 8 * 3).reshape(4, 8, 3)
    blocks = shard_grid(x, mesh)
    for r, blk in enumerate(blocks):
        i, j = divmod(r, 4)
        assert torch.equal(blk, x[2 * i:2 * i + 2, 2 * j:2 * j + 2])
    assert torch.equal(unshard_grid(blocks, mesh), x)
    flat = make_mesh("cpu", n=4)
    assert (flat.shape, flat.names, flat.axis) == ((4,), ("pool",), "pool")
    assert [b.tolist() for b in shard(torch.arange(8), flat)] == [
        [0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError, match="no mesh axis"):
        mesh.axis_size("pool")
    with pytest.raises(ValueError, match="divisible"):
        shard_grid(torch.zeros(3, 8), mesh)


def _inputs(kv_heads=H):
    rng = np.random.default_rng(0)
    return [rng.standard_normal((B, S, h, D)).astype(np.float32)
            for h in (H, kv_heads, kv_heads)]


def _jax_2d(body, arrays, **kw):
    """``__graft_entry__.py``'s composition: ``body`` on the ``seq`` axis,
    vmapped over each device's batch shard, in a ``shard_map`` over a
    (2, 4) ``("data", "seq")`` grid of the 8 virtual devices."""
    grid = Mesh(np.asarray(jax.devices()[:8]).reshape(GRID), ("data", "seq"))
    local = functools.partial(body, axis="seq", causal=True, **kw)
    fn = jax.jit(shard_map(
        lambda q, k, v: jax.vmap(local)(q, k, v), mesh=grid,
        in_specs=(P("data", "seq"),) * 3, out_specs=P("data", "seq"),
        check_vma=False))
    return np.asarray(jax.device_get(fn(*arrays)))


def _reference(arrays):
    q, k, v = (torch.from_numpy(a) for a in arrays)
    return torch.stack([reference_attention(q[b], k[b], v[b], causal=True)
                        for b in range(B)])


@pytest.mark.parametrize("local", ["xla", "flash"])
@pytest.mark.parametrize("use_dma_ring", [True, False])
def test_ring_2d_matches_jax_composition(local, use_dma_ring):
    arrays = _inputs()
    want = _jax_2d(jax_ring_local, arrays, n_devices=GRID[1])
    mesh = make_mesh("cpu", shape=GRID, names=("data", "seq"))
    got = ring_attention(*(torch.from_numpy(a) for a in arrays), mesh,
                         causal=True, local=local, use_dma_ring=use_dma_ring)
    assert got.shape == (B, S, H, D)
    assert np.abs(got.numpy() - want).max() < TOL
    assert (got - _reference(arrays)).abs().max() < TOL


@pytest.mark.parametrize("local", ["reference", "blockwise", "flash"])
def test_ulysses_2d_matches_jax_composition(local):
    arrays = _inputs()
    want = _jax_2d(jax_ulysses_local, arrays,
                   local="blockwise" if local == "flash" else local)
    mesh = make_mesh("cpu", shape=GRID, names=("data", "seq"))
    got = ulysses_attention(*(torch.from_numpy(a) for a in arrays), mesh,
                            causal=True, local=local)
    assert got.shape == (B, S, H, D)
    assert np.abs(got.numpy() - want).max() < TOL
    assert (got - _reference(arrays)).abs().max() < TOL


def test_ring_2d_flash_keeps_gqa_grouping():
    """Two KV heads for four query heads: folding the batch into the
    heads keeps every query head on its own batch element's KV head."""
    arrays = _inputs(kv_heads=2)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    mesh = make_mesh("cpu", shape=GRID, names=("data", "seq"))
    got = ring_attention(q, k, v, mesh, causal=True, local="flash")
    want = torch.stack([flash_attention(q[b], k[b], v[b], causal=True)
                        for b in range(B)])
    assert (got - want).abs().max() < TOL


def test_grid_attention_checks_its_mesh_and_inputs():
    q = torch.zeros(B, S, H, D)
    bad = make_mesh("cpu", shape=GRID, names=("pool", "model"))
    with pytest.raises(ValueError, match="'data', 'seq'"):
        ring_attention(q, q, q, bad)
    mesh = make_mesh("cpu", shape=GRID, names=("data", "seq"))
    with pytest.raises(ValueError, match="batch, seq, heads"):
        ulysses_attention(q[0], q[0], q[0], mesh)
