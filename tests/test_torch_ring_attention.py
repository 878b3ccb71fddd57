"""The port's ring and Ulysses attention against the JAX package's on the
8-device CPU mesh, on the same numpy inputs.

The JAX side runs its synchronous engines (``ppermute``, the native
all-to-all), with the Pallas flash kernel in interpret mode, because its
Pallas DMA ring cannot run on the installed jax; the port runs both of
its engines, the plain copies (``use_dma_ring=False``) and the
``ring_exchange`` path (``True``), whose plain version runs on the CPU,
and its default choice between them (``None``). Every JAX
result is computed once per configuration and shared by the cases that
need it.

Tolerances: f32 within 2e-5 (the JAX suite's flash-vs-reference bound;
the engines sum in other orders), bf16 within 3e-2 (outputs may round to
neighbouring bf16 values).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fiber_tpu.ops.ring_attention import _merge_partials as jax_merge
from fiber_tpu.ops.ring_attention import (
    blockwise_attention as jax_blockwise,
)
from fiber_tpu.ops.ring_attention import ring_attention as jax_ring
from fiber_tpu.ops.ulysses_attention import (
    ulysses_attention as jax_ulysses,
)

from fiber_tpu_torch.ops import dma_ring
from fiber_tpu_torch.ops import ring_attention as ring
from fiber_tpu_torch.ops.ulysses_attention import ulysses_attention
from fiber_tpu_torch.parallel.mesh import make_mesh, shard

N = 8
TOL = {"float32": 2e-5, "bfloat16": 3e-2}


def _jax_mesh():
    return JaxMesh(np.asarray(jax.devices()[:N]), ("pool",))


def _qkv(s, h, d, kvh=None, seed=0):
    rng = np.random.default_rng(seed)
    kvh = kvh or h
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((s, h, d), (s, kvh, d), (s, kvh, d)))


def _jnp(arrays, dtype):
    return [jnp.asarray(a).astype(dtype) for a in arrays]


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _err(got, want):
    return np.abs(got.float().numpy() - np.asarray(want, np.float32)).max()


@functools.cache
def _jax_ring(local, causal, kvh, dtype):
    q, k, v = _jnp(_qkv(256, 4, 16, kvh=kvh), getattr(jnp, dtype))
    out = jax_ring(q, k, v, mesh=_jax_mesh(), causal=causal, local=local,
                   interpret=True)
    return np.asarray(jax.device_get(out.astype(jnp.float32)))


# (local, causal, kv_heads, dtype)
RING_CASES = {
    "xla": ("xla", False, None, "float32"),
    "xla_causal": ("xla", True, None, "float32"),
    "flash": ("flash", False, None, "float32"),
    "flash_causal": ("flash", True, None, "float32"),
    "flash_causal_gqa": ("flash", True, 2, "float32"),
    "flash_causal_bf16": ("flash", True, None, "bfloat16"),
}


@pytest.mark.parametrize("use_dma_ring", [False, True, None])
@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_attention_matches_jax(case, use_dma_ring):
    local, causal, kvh, dtype = RING_CASES[case]
    want = _jax_ring(local, causal, kvh, dtype)
    q, k, v = _torch(_qkv(256, 4, 16, kvh=kvh), getattr(torch, dtype))
    got = ring.ring_attention(q, k, v, make_mesh("cpu", n=N),
                              causal=causal, local=local,
                              use_dma_ring=use_dma_ring)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_flash_launch_plan(causal, monkeypatch):
    """Launch plan of the flash ring: every rank runs its diagonal block
    and (causal) only its past blocks, so a future block launches
    nothing; the DMA ring rotates n - 1 times, one call for K and V of
    every rank."""
    calls = {"flash": 0, "exchange": 0}
    flash, exchange = ring.flash_attention_lse, ring.ring_exchange

    def counted_flash(*a, **kw):
        calls["flash"] += 1
        return flash(*a, **kw)

    def counted_exchange(arrays, mesh):
        calls["exchange"] += 1
        assert len(arrays) == 2 and len(arrays[0]) == N
        return exchange(arrays, mesh)

    monkeypatch.setattr(ring, "flash_attention_lse", counted_flash)
    monkeypatch.setattr(ring, "ring_exchange", counted_exchange)
    q, k, v = _torch(_qkv(64, 2, 8), torch.float32)
    ring.ring_attention(q, k, v, make_mesh("cpu", n=N), causal=causal,
                        local="flash", use_dma_ring=True)
    assert calls == {"flash": N + N * (N - 1) // 2 if causal else N * N,
                     "exchange": N - 1}


@pytest.mark.parametrize("plane", ["ring", "ulysses"])
def test_default_engine_follows_the_gradient(plane, monkeypatch):
    """With use_dma_ring left to its default, rotations run the
    ring_exchange path when no block needs a gradient and the
    differentiable plain copies when one does."""
    calls = []
    exchange = dma_ring.ring_exchange

    def counted(arrays, mesh):
        calls.append(len(arrays))
        return exchange(arrays, mesh)

    monkeypatch.setattr(dma_ring, "ring_exchange", counted)
    monkeypatch.setattr(ring, "ring_exchange", counted)
    attend = ring.ring_attention if plane == "ring" else ulysses_attention
    mesh = make_mesh("cpu", n=4)
    q, k, v = _torch(_qkv(64, 8, 4, seed=8), torch.float32)
    with torch.no_grad():
        want = attend(q, k, v, mesh, causal=True, local="blockwise")
    assert len(calls) == (3 if plane == "ring" else 4 * 3)
    calls.clear()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    got = attend(*leaves, mesh, causal=True, local="blockwise")
    assert calls == []
    got.sum().backward()
    assert all(x.grad is not None and torch.isfinite(x.grad).all()
               for x in leaves)
    assert _err(got.detach(), want.numpy()) < 1e-6


@pytest.mark.parametrize("causal", [False, True])
def test_blockwise_attention_matches_jax(causal):
    """S = 1100: one full 1024-row KV chunk and a ragged tail."""
    arrays = _qkv(1100, 2, 8, seed=3)
    q, k, v = _jnp(arrays, jnp.float32)
    want = jax_blockwise(q, k, v, causal=causal)
    got = ring.blockwise_attention(*_torch(arrays, torch.float32),
                                   causal=causal)
    assert _err(got, want) < TOL["float32"]


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(4)
    o1, o2 = (rng.standard_normal((16, 3, 8)).astype(np.float32)
              for _ in range(2))
    lse1, lse2 = (rng.standard_normal((3, 16)).astype(np.float32)
                  for _ in range(2))
    lse2[1] = -1e30                                 # a skipped part
    want_o, want_l = jax_merge(
        *(jnp.asarray(a) for a in (o1, lse1, o2, lse2)))
    got_o, got_l = ring._merge_partials(
        *(torch.from_numpy(a) for a in (o1, lse1, o2, lse2)))
    assert _err(got_o, want_o) < 1e-6 and _err(got_l, want_l) < 1e-6
    assert torch.equal(got_o[:, 1], torch.from_numpy(o1[:, 1]))


def test_ring_attention_local_takes_rank_blocks():
    """The composition form: per-rank blocks in, per-rank blocks out,
    equal to the global form's shards."""
    mesh = make_mesh("cpu", n=4)
    q, k, v = _torch(_qkv(32, 2, 4, seed=5), torch.float32)
    blocks = [shard(x, mesh) for x in (q, k, v)]
    out = ring.ring_attention_local(*blocks, mesh, causal=True)
    want = shard(ring.ring_attention(q, k, v, mesh, causal=True), mesh)
    assert all(torch.equal(a, b) for a, b in zip(out, want))
    with pytest.raises(ValueError, match="unknown local"):
        ring.ring_attention_local(*blocks, mesh, local="nope")


@functools.cache
def _jax_ulysses(local, causal):
    q, k, v = _jnp(_qkv(128, 8, 16, seed=6), jnp.float32)
    out = jax_ulysses(q, k, v, mesh=_jax_mesh(), causal=causal,
                      local=local)
    return np.asarray(jax.device_get(out))


@pytest.mark.parametrize("use_dma_ring", [False, True, None])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("local", ["reference", "blockwise", "flash"])
def test_ulysses_attention_matches_jax(local, causal, use_dma_ring):
    want = _jax_ulysses(local, causal)
    q, k, v = _torch(_qkv(128, 8, 16, seed=6), torch.float32)
    got = ulysses_attention(q, k, v, make_mesh("cpu", n=N), causal=causal,
                            local=local, use_dma_ring=use_dma_ring)
    assert got.shape == q.shape
    assert _err(got, want) < TOL["float32"]


def test_ulysses_dma_ring_rotation_count(monkeypatch):
    """Four swaps (q, k, v in; the output back), n - 1 rotations each."""
    calls = []
    exchange = dma_ring.ring_exchange

    def counted(arrays, mesh):
        calls.append(len(arrays))
        return exchange(arrays, mesh)

    monkeypatch.setattr(dma_ring, "ring_exchange", counted)
    q, k, v = _torch(_qkv(64, 8, 4, seed=7), torch.float32)
    ulysses_attention(q, k, v, make_mesh("cpu", n=4), causal=True,
                      local="flash", use_dma_ring=True)
    assert calls == [1] * (4 * 3)


def test_ulysses_rejects_indivisible_shapes():
    mesh = make_mesh("cpu", n=N)
    q, k, v = _torch(_qkv(60, 8, 4), torch.float32)
    with pytest.raises(ValueError, match="seq 60"):
        ulysses_attention(q, k, v, mesh)
    q, k, v = _torch(_qkv(64, 6, 4), torch.float32)
    with pytest.raises(ValueError, match="heads % n_dev"):
        ulysses_attention(q, k, v, mesh)
