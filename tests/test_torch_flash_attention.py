"""The port's flash-attention forward (plain version, on the CPU) against
the JAX package's Pallas kernels run in interpret mode, and the port's
reference attention against the JAX reference.

Tolerances are the JAX package's own (tests/test_pallas_attention.py):
2e-5 in f32 (two f32 online softmaxes in different orders), 3e-2 in
bf16 (one rounding of inputs and outputs to bf16).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fiber_tpu.ops.pallas_attention import (
    flash_attention as jax_flash,
    flash_attention_lse as jax_flash_lse,
)
from fiber_tpu.ops.ring_attention import reference_attention as jax_ref

from fiber_tpu_torch.ops import flash_attention as fa
from fiber_tpu_torch.ops import ring_attention as ra
from fiber_tpu_torch.utils import flops
from tests._torch_tf32 import product


def _qkv(s, h, kvh, d, seed=7):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((s, h, d), (s, kvh, d), (s, kvh, d)))


def _both(arrays, dtype):
    jx = tuple(jnp.asarray(a, dtype) for a in arrays)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    tx = tuple(torch.from_numpy(a).to(tdt) for a in arrays)
    return jx, tx


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jax.device_get(x), dtype=np.float32)


# (S, heads, kv_heads, head_dim, causal, window, block_q, block_kv, dtype, tol)
CASES = {
    "noncausal": (256, 2, 2, 64, False, None, 128, 128, jnp.float32, 2e-5),
    "causal": (256, 2, 2, 64, True, None, 128, 128, jnp.float32, 2e-5),
    "gqa": (256, 4, 2, 32, True, None, 128, 128, jnp.float32, 2e-5),
    "window": (256, 2, 1, 32, True, 48, 128, 128, jnp.float32, 2e-5),
    "multi_sweep": (384, 3, 3, 64, True, None, 384, 128, jnp.float32, 2e-5),
    "bf16": (256, 2, 2, 64, True, None, 128, 128, jnp.bfloat16, 3e-2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_flash_matches_jax_flash(case):
    s, h, kvh, d, causal, window, bq, bk, dtype, tol = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s, h, kvh, d), dtype)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=bq, block_kv=bk,
                     interpret=True, window=window)
    before = fa.flash_fwd.launches
    got = fa.flash_attention(tq, tk, tv, causal=causal, block_q=bq,
                             block_kv=bk, window=window)
    assert fa.flash_fwd.launches == before  # the CPU runs no kernel
    assert got.dtype == tq.dtype and got.shape == (s, h, d)
    assert np.abs(_np(got) - _np(want)).max() < tol


@pytest.mark.parametrize("causal", [False, True])
def test_plain_lse_matches_jax_lse(causal):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(256, 4, 2, 32, seed=3),
                                       jnp.float32)
    want_o, want_lse = jax_flash_lse(jq, jk, jv, causal=causal,
                                     block_q=128, block_kv=128,
                                     interpret=True)
    got_o, got_lse = fa.flash_attention_lse(tq, tk, tv, causal=causal)
    assert got_lse.dtype == torch.float32 and got_lse.shape == (4, 256)
    assert np.abs(_np(got_o) - _np(want_o)).max() < 2e-5
    assert np.abs(_np(got_lse) - _np(want_lse)).max() < 2e-5


@pytest.mark.parametrize("window", [None, 5])
def test_plain_flash_row_chunks_agree(monkeypatch, window):
    """Query rows in many chunks (as at S = 16384 on the card) give
    what one chunk gives, ragged last chunk included."""
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(100, 4, 2, 8))
    whole = fa.flash_attention_lse(tq, tk, tv, causal=True, window=window)
    monkeypatch.setattr(fa, "_CHUNK_ELEMS", 4 * 100 * 7)   # 7-row chunks
    parts = fa.flash_attention_lse(tq, tk, tv, causal=True, window=window)
    for a, b in zip(whole, parts):
        assert torch.allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(monkeypatch, causal):
    arrays = _qkv(96, 3, 3, 16, seed=11)
    want = jax_ref(*(jnp.asarray(a) for a in arrays), causal=causal)
    monkeypatch.setattr(ra, "_CHUNK_ELEMS", 3 * 96 * 10)   # 10-row chunks
    got = ra.reference_attention(*(torch.from_numpy(a) for a in arrays),
                                 causal=causal)
    assert np.abs(_np(got) - _np(want)).max() < 2e-5


def test_window_of_one_attends_only_self():
    """window=1 keeps one key per row: O = v and lse = q.k * scale."""
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(8, 1, 1, 4))
    o, lse = fa.flash_attention_lse(tq, tk, tv, causal=True, window=1)
    assert torch.allclose(o, tv, atol=1e-6)
    assert torch.allclose(
        lse[0], (tq[:, 0] * tk[:, 0]).sum(-1) / 2.0, atol=1e-6)
    with pytest.raises(ValueError):
        fa.flash_attention(tq, tk, tv, causal=True, window=0)


@pytest.mark.parametrize("bad", ["window_noncausal", "kv_heads", "dtype",
                                 "shape", "device"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 4, 2, 8))
    kwargs = {"causal": True}
    err = ValueError
    if bad == "window_noncausal":
        kwargs = {"causal": False, "window": 4}
    elif bad == "kv_heads":
        k = v = torch.zeros(16, 3, 8)
    elif bad == "dtype":
        k = k.double()
        err = TypeError
    elif bad == "shape":
        q = q[:8]
    elif bad == "device":
        q, k, v = (x.to("meta") for x in (q, k, v))
    with pytest.raises(err):
        fa.flash_fwd(q, k, v, **kwargs)


def test_flops_counters_match_jax_package():
    from fiber_tpu.models.transformer import TinyLM as JaxTinyLM
    from fiber_tpu.utils import flops as jax_flops

    for args in ((16384, 8, 32, True, None), (16384, 8, 64, True, 1024),
                 (300, 2, 8, False, None)):
        assert flops.attention_flops(*args[:4], window=args[4]) == \
            jax_flops.attention_flops(*args[:4], window=args[4])
    for kvh, window in ((None, None), (2, 1024)):
        m = JaxTinyLM(vocab=256, dim=256, heads=8, layers=4, max_seq=16384,
                      attention="flash", kv_heads=kvh, window=window)
        for train in (False, True):
            assert flops.tinylm_flops_per_step(m, 16384, train) == \
                jax_flops.tinylm_flops_per_step(m, 16384, train)
    # f32 operations run at 3xTF32's 495 / 3 TFLOP/s (flops.op_peak)
    ms, by = flops.bound_ms(165e12, 1.0, "float32")
    assert (ms, by) == (1e3, "operations")
    ms, by = flops.bound_ms(1.0, 3.35e12, "bfloat16")
    assert (ms, by) == (1e3, "bytes")


# ---------------------------------------------------------------------------
# The arithmetic of csrc/flash_fwd.cu on f32 inputs, emulated: per 64-key
# tile, S = Q K^T and P V on TF32 tensor cores (tests/_torch_tf32.py), the
# online softmax in f32, and each tile's P V summed from zero and folded
# into O with rounded f32 operations.
# ---------------------------------------------------------------------------


def _fwd_emulated(q, k, v, scheme, tile=64):
    """O (S, heads, D) of the kernel's f32 path, causal."""
    s, h, d = q.shape
    group = h // k.shape[1]
    pos = torch.arange(s)
    out = torch.empty_like(q)
    for ih in range(h):
        qh, kh, vh = q[:, ih], k[:, ih // group], v[:, ih // group]
        m = torch.full((s, 1), -1e30)
        l = torch.zeros(s, 1)
        o = torch.zeros(s, d)
        for k0 in range(0, s, tile):
            keep = pos[:, None] >= pos[None, k0:k0 + tile]
            sc = product(qh, kh[k0:k0 + tile].T, scheme) / d ** 0.5
            sc = sc.masked_fill(~keep, -1e30)
            m_new = torch.maximum(m, sc.amax(1, keepdim=True))
            p = torch.exp(sc - m_new) * keep
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(1, keepdim=True)
            o = o * corr + product(p, vh[k0:k0 + tile], scheme)
            m = m_new
        out[:, ih] = o / l
    return out


@functools.cache
def _fwd_f64_case(kv_heads):
    """f32 inputs at S = 2048, D = 32 (4 query heads), and causal attention
    recomputed from them in f64."""
    s, h, d = 2048, 4, 32
    q, k, v = (torch.from_numpy(a) for a in _qkv(s, h, kv_heads, d, seed=13))
    group = h // kv_heads
    kf, vf = (x.double().repeat_interleave(group, dim=1).permute(1, 0, 2)
              for x in (k, v))
    sc = q.double().permute(1, 0, 2) @ kf.transpose(1, 2) / d ** 0.5
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        -torch.inf)
    want = (torch.softmax(sc, dim=-1) @ vf).permute(1, 0, 2)
    return (q, k, v), want


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("scheme", ["tf32", "3xtf32"])
def test_fwd_f32_products_need_3xtf32(scheme, kv_heads):
    """Why the forward kernel runs f32 as 3xTF32: against an f64
    recomputation, its emulated O stays under the card's f32 parity bound
    (chip_smoke.py's TOL, 2e-5) by a factor of ten with 3xTF32 and misses
    it with one TF32 product."""
    bound = 2e-5
    inputs, want = _fwd_f64_case(kv_heads)
    err = (_fwd_emulated(*inputs, scheme).double() - want).abs().max().item()
    if scheme == "3xtf32":
        assert err < bound / 10, err
    else:
        assert err > bound, err
