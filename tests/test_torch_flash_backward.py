"""The port's flash-attention backward (the autograd Function over the
plain versions of the dq and dk/dv kernels, on the CPU) against
``jax.grad`` through the JAX package's Pallas kernels in interpret mode.

Tolerance: max abs error over max |want| below 2e-5 in f32 (two f32
recurrences whose sums run in different orders) and 3e-2 in bf16 (inputs,
outputs and gradients rounded to bf16 at different places), the forward
tests' bounds.
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

from fiber_tpu_torch.ops import flash_attention as fa
from tests._torch_tf32 import product
from tests.test_torch_flash_attention import CASES, _both, _np, _qkv


def _close(got, want, tol):
    """max |got - want| <= tol * max |want| (so an all-zero want, as dv
    of a loss on lse alone, must be met exactly)."""
    got, want = _np(got), _np(want)
    return np.abs(got - want).max() <= tol * np.abs(want).max()


def _launches():
    return (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches)


def _leaves(tx):
    return tuple(t.detach().clone().requires_grad_() for t in tx)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_jax_grad(case):
    s, h, kvh, d, causal, window, bq, bk, dtype, tol = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s, h, kvh, d), dtype)
    dout_np = np.random.default_rng(5).standard_normal((s, h, d)).astype(
        np.float32)
    (jdo,), (tdo,) = _both((dout_np,), dtype)

    def loss(q, k, v):
        out = jax_flash(q, k, v, causal=causal, block_q=bq, block_kv=bk,
                        interpret=True, window=window)
        return jnp.sum(out.astype(jnp.float32) * jdo.astype(jnp.float32))

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    before = _launches()
    q, k, v = _leaves((tq, tk, tv))
    out = fa.flash_attention(q, k, v, causal=causal, block_q=bq,
                             block_kv=bk, window=window)
    got = torch.autograd.grad((out.float() * tdo.float()).sum(), (q, k, v))
    assert _launches() == before   # the CPU runs no kernel
    for g, x in zip(got, (tq, tk, tv)):
        assert g.dtype == x.dtype and g.shape == x.shape
    for g, w in zip(got, want):
        assert _close(g, w, tol)

    # the plain backward called directly is what autograd ran
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal=causal,
                                          window=window)
    direct = fa.flash_attention_bwd_reference(tq, tk, tv, o, lse, tdo,
                                              causal=causal, window=window)
    for a, b in zip(direct, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("causal", [False, True])
def test_lse_cotangent_matches_jax(causal):
    """A loss on both outputs of flash_attention_lse: the lse cotangent
    enters as ``delta - dlse``."""
    arrays = _qkv(256, 4, 2, 32, seed=3)
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, jnp.float32)
    rng = np.random.default_rng(9)
    dout = rng.standard_normal((256, 4, 32)).astype(np.float32)
    dlse = rng.standard_normal((4, 256)).astype(np.float32)

    def loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, causal=causal, block_q=128,
                                 block_kv=128, interpret=True)
        return jnp.sum(out * dout) + jnp.sum(lse * dlse)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = _leaves((tq, tk, tv))
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    total = ((out * torch.from_numpy(dout)).sum()
             + (lse * torch.from_numpy(dlse)).sum())
    got = torch.autograd.grad(total, (q, k, v))
    for g, w in zip(got, want):
        assert _close(g, w, 2e-5)

    # only lse used: O's cotangent arrives as None and is taken as zeros
    def lse_loss(q, k, v):
        _, lse = jax_flash_lse(q, k, v, causal=causal, block_q=128,
                               block_kv=128, interpret=True)
        return jnp.sum(lse * dlse)

    want = jax.grad(lse_loss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = _leaves((tq, tk, tv))
    _, lse = fa.flash_attention_lse(q, k, v, causal=causal)
    got = torch.autograd.grad((lse * torch.from_numpy(dlse)).sum(),
                              (q, k, v))
    for g, w in zip(got, want):
        assert _close(g, w, 2e-5)


@pytest.mark.parametrize("window", [None, 5])
def test_plain_backward_row_chunks_agree(monkeypatch, window):
    """Query rows in many chunks (as at S = 16384 on the card) give the
    gradients one chunk gives, ragged last chunk included: dk and dv
    accumulate across chunks (f32 sums split at other rows, so within
    1e-6 of the largest gradient)."""
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(100, 4, 2, 8))
    rng = np.random.default_rng(2)
    dout = torch.from_numpy(rng.standard_normal((100, 4, 8)).astype(
        np.float32))
    dlse = torch.from_numpy(rng.standard_normal((4, 100)).astype(
        np.float32))
    o, lse = fa.flash_attention_reference(tq, tk, tv, causal=True,
                                          window=window)
    args = (tq, tk, tv, o, lse, dout, dlse)
    whole = fa.flash_attention_bwd_reference(*args, causal=True,
                                             window=window)
    monkeypatch.setattr(fa, "_CHUNK_ELEMS", 4 * 100 * 7)   # 7-row chunks
    parts = fa.flash_attention_bwd_reference(*args, causal=True,
                                             window=window)
    for a, b in zip(whole, parts):
        assert _close(b, a, 1e-6)


def test_sum_loss_gives_zero_stride_cotangent():
    """``out.sum()`` hands the Function an expanded (zero-stride) dO; the
    gradients equal those of an explicit all-ones cotangent."""
    tq, tk, tv = (torch.from_numpy(a) for a in _qkv(64, 4, 2, 16, seed=4))
    q, k, v = _leaves((tq, tk, tv))
    a = torch.autograd.grad(
        fa.flash_attention(q, k, v, causal=True).sum(), (q, k, v))
    q, k, v = _leaves((tq, tk, tv))
    out = fa.flash_attention(q, k, v, causal=True)
    b = torch.autograd.grad(out, (q, k, v), torch.ones(64, 4, 16))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["dout_shape", "dout_dtype", "lse_shape",
                                 "delta_dtype", "window_noncausal"])
def test_backward_wrappers_refuse_what_the_kernels_do_not_take(bad):
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 4, 2, 8))
    dout = torch.zeros(16, 4, 8)
    lse = delta = torch.zeros(4, 16)
    kwargs = {"causal": True}
    if bad == "dout_shape":
        dout = dout[:8]
    elif bad == "dout_dtype":
        dout = dout.double()
    elif bad == "lse_shape":
        lse = torch.zeros(16, 4)
    elif bad == "delta_dtype":
        delta = delta.double()
    elif bad == "window_noncausal":
        kwargs = {"causal": False, "window": 4}
    for wrapper in (fa.flash_bwd_dq, fa.flash_bwd_dkv):
        with pytest.raises(ValueError):
            wrapper(q, k, v, dout, lse, delta, **kwargs)


def test_backward_flops_convention():
    from fiber_tpu_torch.utils import flops

    for args in ((16384, 8, 32, True, None), (16384, 8, 32, True, 1024),
                 (300, 2, 8, False, None)):
        fwd = flops.attention_flops(*args[:4], window=args[4])
        assert flops.attention_bwd_flops(*args[:4], window=args[4],
                                         part="dq") == 1.5 * fwd
        assert flops.attention_bwd_flops(*args[:4], window=args[4],
                                         part="dkv") == 2 * fwd
    # the bounds the kernels are held to at the LM's shape: an f32 product
    # at its fastest is three TF32 products on the tensor cores (3xTF32,
    # 165 TFLOP/s), not FMA on the CUDA cores (67 TFLOP/s, 3.077 ms for dq)
    assert flops.op_peak("float32") == (495e12 / 3, "3xtf32")
    assert flops.op_peak("bfloat16") == (989e12, "tensor cores")
    dq = flops.attention_bwd_flops(16384, 8, 32, part="dq")
    dkv = flops.attention_bwd_flops(16384, 8, 32, part="dkv")
    assert dq / flops.H100_PEAK_FLOPS["float32"] * 1e3 == pytest.approx(
        3.077, abs=1e-3)
    assert flops.bound_ms(dq, 0, "float32") == (
        pytest.approx(1.249, abs=1e-3), "operations")
    assert flops.bound_ms(dkv, 0, "float32") == (
        pytest.approx(1.666, abs=1e-3), "operations")
    assert flops.bound_ms(dkv, 0, "bfloat16")[0] == pytest.approx(0.278,
                                                                  abs=1e-3)


# ---------------------------------------------------------------------------
# The arithmetic of csrc/flash_bwd_dkv.cu and csrc/flash_bwd_dq.cu on f32
# inputs, emulated: their products (dk/dv: S^T = K Q^T, dP^T = V dO^T,
# dV += P^T dO, dK += dS^T Q; dq: S = Q K^T, dP = dO V^T, dQ += dS K) run
# on TF32 tensor cores (tests/_torch_tf32.py).
# ---------------------------------------------------------------------------


def _dkv_emulated(q, k, v, dout, lse, delta, scheme):
    """dk, dv (S, kv_heads, D) of the kernel's f32 path, per query head and
    summed over each GQA group, causal; f32 elementwise work as in the
    kernel."""
    s, h, d = q.shape
    group = h // k.shape[1]
    keep = torch.ones(s, s, dtype=torch.bool).tril()     # (query, key)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    for ih in range(h):
        kvh = ih // group
        qh, doh = q[:, ih], dout[:, ih]
        kh, vh = k[:, kvh], v[:, kvh]
        st = product(kh, qh.T, scheme)                   # (key, query)
        pt = torch.exp(st / d ** 0.5 - lse[ih][None, :]) * keep.T
        dpt = product(vh, doh.T, scheme)
        dst = pt * (dpt - delta[ih][None, :])
        dv[:, kvh] += product(pt, doh, scheme)
        dk[:, kvh] += product(dst, qh, scheme) / d ** 0.5
    return dk, dv


def _dq_emulated(q, k, v, dout, lse, delta, scheme):
    """dq (S, heads, D) of the kernel's f32 path, per query head, causal;
    f32 elementwise work as in the kernel."""
    s, h, d = q.shape
    group = h // k.shape[1]
    keep = torch.ones(s, s, dtype=torch.bool).tril()     # (query, key)
    dq = torch.zeros_like(q)
    for ih in range(h):
        kh, vh = k[:, ih // group], v[:, ih // group]
        sc = product(q[:, ih], kh.T, scheme)              # (query, key)
        p = torch.exp(sc / d ** 0.5 - lse[ih][:, None]) * keep
        dp = product(dout[:, ih], vh.T, scheme)
        ds = p * (dp - delta[ih][:, None])
        dq[:, ih] = product(ds, kh, scheme) / d ** 0.5
    return dq


@functools.cache
def _bwd_f64_case(kv_heads):
    """Inputs at S = 2048, D = 32 (4 query heads), causal, with lse and
    delta rounded to f32 from an f64 forward, and dq, dk, dv recomputed
    in f64."""
    s, h, d = 2048, 4, 32
    rng = np.random.default_rng(11)
    q, dout = (rng.standard_normal((s, h, d)) for _ in range(2))
    k, v = (rng.standard_normal((s, kv_heads, d)) for _ in range(2))
    q, k, v, dout = (torch.from_numpy(x) for x in (q, k, v, dout))
    group = h // kv_heads
    kf, vf = (x.repeat_interleave(group, dim=1).permute(1, 0, 2)
              for x in (k, v))
    qf, dof = q.permute(1, 0, 2), dout.permute(1, 0, 2)
    sc = qf @ kf.transpose(1, 2) / d ** 0.5
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        -torch.inf)
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.exp(sc - lse[..., None])
    out = p @ vf
    delta = (dof * out).sum(-1)
    ds = p * (dof @ vf.transpose(1, 2) - delta[..., None])
    dk = (ds.transpose(1, 2) @ qf / d ** 0.5).reshape(
        kv_heads, group, s, d).sum(1).permute(1, 0, 2)
    dv = (p.transpose(1, 2) @ dof).reshape(kv_heads, group, s, d).sum(
        1).permute(1, 0, 2)
    dq = (ds @ kf / d ** 0.5).permute(1, 0, 2)
    f32 = (q.float(), k.float(), v.float(), dout.float(), lse.float(),
           delta.float())
    return f32, (dq, dk, dv)


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("scheme", ["tf32", "3xtf32"])
def test_dkv_f32_products_need_3xtf32(scheme, kv_heads):
    """Why the dk/dv kernel runs f32 as 3xTF32: against an f64
    recomputation, its emulated products stay under the card's f32 parity
    bound (chip_smoke.py's BWD_TOL, 5e-5 of the largest gradient) with
    3xTF32 and miss it with one TF32 product."""
    bound = 5e-5
    inputs, want = _bwd_f64_case(kv_heads)
    got = _dkv_emulated(*inputs, scheme)
    errs = [((g.double() - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want[1:])]
    if scheme == "3xtf32":
        assert max(errs) < bound / 10, errs
    else:
        assert min(errs) > bound, errs


@pytest.mark.parametrize("kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("scheme", ["tf32", "3xtf32"])
def test_dq_f32_products_need_3xtf32(scheme, kv_heads):
    """Why the dq kernel runs f32 as 3xTF32: against an f64 recomputation,
    its emulated products stay under a tenth of the card's f32 parity
    bound (chip_smoke.py's BWD_TOL, 5e-5 of the largest gradient) with
    3xTF32, and one TF32 product misses the bound."""
    bound = 5e-5
    inputs, want = _bwd_f64_case(kv_heads)
    got = _dq_emulated(*inputs, scheme)
    err = ((got.double() - want[0]).abs().max()
           / want[0].abs().max()).item()
    if scheme == "3xtf32":
        assert err < bound / 10, err
    else:
        assert err > bound, err
