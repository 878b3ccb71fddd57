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
from tests.test_torch_flash_attention import (
    CASES,
    WIDE_F32_CASES,
    _both,
    _fwd_wgmma_emulated,
    _np,
    _qkv,
)


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


@pytest.mark.parametrize("case", WIDE_F32_CASES)
def test_wide_lse_cotangent_matches_jax(case):
    """Past head_dim 256 (the kernels' wide route on the card), a loss on
    both outputs of flash_attention_lse, as above, at the case's shape,
    causality, GQA and window: within the f32 bound, 2e-5."""
    s, h, kvh, d, causal, window, bq, bk, dtype, tol = CASES[case]
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(s, h, kvh, d, seed=3), dtype)
    rng = np.random.default_rng(9)
    dout = rng.standard_normal((s, h, d)).astype(np.float32)
    dlse = rng.standard_normal((h, s)).astype(np.float32)

    def loss(q, k, v):
        out, lse = jax_flash_lse(q, k, v, causal=causal, block_q=bq,
                                 block_kv=bk, interpret=True, window=window)
        return jnp.sum(out * dout) + jnp.sum(lse * dlse)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    q, k, v = _leaves((tq, tk, tv))
    out, lse = fa.flash_attention_lse(q, k, v, causal=causal, window=window)
    total = ((out * torch.from_numpy(dout)).sum()
             + (lse * torch.from_numpy(dlse)).sum())
    got = torch.autograd.grad(total, (q, k, v))
    for g, w in zip(got, want):
        assert _close(g, w, tol)


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


# ---------------------------------------------------------------------------
# The arithmetic of both backward kernels on f16 inputs, emulated: the
# score products of f16 values summed in f32, P and dS in f32, then
# rounded to f16 (pack16 in mma_sm90.cuh) as the A operands of dV += P^T
# dO, dK += dS^T Q and dQ += dS K, whose sums are f32; the scale applied
# in f32 and each gradient rounded to f16 once.
# ---------------------------------------------------------------------------

#: chip_smoke.py's BWD_TOL["float16"], max abs error over max |gradient|
F16_BWD_TOL = 4e-3
F16_MAX = 65504.0    # the largest finite f16


def _f16(x):
    return x.half().float()


def _bwd_emulated_f16(q, k, v, dout, lse, delta):
    """(dq, dk, dv) of the kernels' f16 path, causal, and the largest
    |dS| they pack, from f32 tensors that hold f16 values."""
    s, h, d = q.shape
    group = h // k.shape[1]
    keep = torch.ones(s, s, dtype=torch.bool).tril()     # (query, key)
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    ds_max = 0.0
    for ih in range(h):
        kvh = ih // group
        kh, vh = k[:, kvh], v[:, kvh]
        p = torch.exp(q[:, ih] @ kh.T / d ** 0.5 - lse[ih][:, None]) * keep
        ds = p * (dout[:, ih] @ vh.T - delta[ih][:, None])
        ds_max = max(ds_max, ds.abs().max().item())
        dq[:, ih] = _f16(ds) @ kh / d ** 0.5
        dv[:, kvh] += _f16(p).T @ dout[:, ih]
        dk[:, kvh] += _f16(ds).T @ q[:, ih] / d ** 0.5
    return (_f16(dq), _f16(dk), _f16(dv)), ds_max


@functools.cache
def _bwd_f16_case(head_dim):
    """f16 inputs and dO at S = 2048 (4 query heads, 2 KV heads), held in
    f32; lse and delta from an f64 forward, rounded to f32; dq, dk, dv
    recomputed in f64; and the kernels' bound on |dS|, 2 max_i |dO_i|
    max_j |v_j| (no lse cotangent)."""
    s, h, kvh, d = 2048, 4, 2, head_dim
    rng = np.random.default_rng(19)
    q, dout = (_f16(torch.from_numpy(rng.standard_normal((s, h, d))))
               for _ in range(2))
    k, v = (_f16(torch.from_numpy(rng.standard_normal((s, kvh, d))))
            for _ in range(2))
    group = h // kvh
    kf, vf = (x.double().repeat_interleave(group, dim=1).permute(1, 0, 2)
              for x in (k, v))
    qf, dof = q.double().permute(1, 0, 2), dout.double().permute(1, 0, 2)
    sc = qf @ kf.transpose(1, 2) / d ** 0.5
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        -torch.inf)
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.exp(sc - lse[..., None])
    delta = (dof * (p @ vf)).sum(-1)
    ds = p * (dof @ vf.transpose(1, 2) - delta[..., None])
    dk = (ds.transpose(1, 2) @ qf / d ** 0.5).reshape(
        kvh, group, s, d).sum(1).permute(1, 0, 2)
    dv = (p.transpose(1, 2) @ dof).reshape(kvh, group, s, d).sum(
        1).permute(1, 0, 2)
    dq = (ds @ kf / d ** 0.5).permute(1, 0, 2)
    bound = 2 * dout.norm(dim=-1).max().item() * v.norm(dim=-1).max().item()
    return (q, k, v, dout, lse.float(), delta.float()), (dq, dk, dv), bound


@pytest.mark.parametrize("head_dim", [64, 256, 512])
def test_bwd_f16_rounding_stays_inside_the_f16_bound(head_dim):
    """The backward kernels' f16 path packs P and dS to f16: against an
    f64 recomputation from the same f16 inputs, the emulated dq, dk and
    dv stay inside the card's f16 bound (F16_BWD_TOL of the largest
    gradient), and dS stays under its bound, 2 |dO_i| max_j |v_j|, which
    is far under f16's largest value: packing it cannot overflow."""
    inputs, want, bound = _bwd_f16_case(head_dim)
    got, ds_max = _bwd_emulated_f16(*inputs)
    errs = [((g.double() - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]
    assert max(errs) < F16_BWD_TOL, errs
    assert ds_max <= bound < F16_MAX / 10, (ds_max, bound)


# ---------------------------------------------------------------------------
# The arithmetic of the backward kernels' wide route (head_dim 257-1024:
# flash_bwd_dq_wide_kernel, flash_bwd_dkv_wide_kernel), emulated. A
# cluster block holds one 128-column depth slice of the operands, so S and
# dP are sums of one partial product a slice (3xTF32 for f32), added in
# f32 in the order of the slices; P and dS come from the sums, and are
# packed to the input's type where the kernels pack them (16-bit types)
# before the products dQ += dS K, dV += P^T dO and dK += dS^T Q.
# ---------------------------------------------------------------------------

#: max abs error over max |gradient| against the f64 recomputation: a
#: tenth of chip_smoke.py's f32 bound (5e-5), as for the 3xTF32 cases
#: above; the f16 bound of the f16 cases; chip_smoke.py's bf16 bound
WIDE_EMULATION_BOUND = {"float32": 5e-5 / 10, "float16": F16_BWD_TOL,
                        "bfloat16": 3e-2}
_ROUND = {"float32": lambda x: x, "float16": _f16,
          "bfloat16": lambda x: x.bfloat16().float()}


def _wide_product(a, b, dtype):
    """a @ b in f32 as the wide route's products run it: 3xTF32 for f32
    inputs; exact products of 16-bit values summed in f32 otherwise."""
    return product(a, b, "3xtf32") if dtype == "float32" else a @ b


def _wide_scores(a, b, dtype):
    """a b^T (rows of a against rows of b, over head_dim) as the cluster
    sums it: one partial product per 128-column depth slice, in f32 and
    in the order of the slices (the blocks' ranks)."""
    d = a.shape[1]
    total = None
    for c in range(0, d, 128):
        part = _wide_product(a[:, c:c + 128], b[:, c:c + 128].T, dtype)
        total = part if total is None else total + part
    return total


def _wide_bwd_emulated(q, k, v, dout, lse, delta, keep, dtype):
    """(dq, dk, dv) of the wide route and the largest |dS| it packs, from
    f32 tensors holding values of ``dtype``; ``keep`` (query, key)."""
    s, h, d = q.shape
    group = h // k.shape[1]
    pack = _ROUND[dtype]
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    ds_max = 0.0
    for ih in range(h):
        kvh = ih // group
        kh, vh = k[:, kvh], v[:, kvh]
        p = torch.exp(_wide_scores(q[:, ih], kh, dtype) / d ** 0.5
                      - lse[ih][:, None]) * keep
        ds = p * (_wide_scores(dout[:, ih], vh, dtype) - delta[ih][:, None])
        ds_max = max(ds_max, ds.abs().max().item())
        p, ds = pack(p), pack(ds)
        dq[:, ih] = _wide_product(ds, kh, dtype) / d ** 0.5
        dv[:, kvh] += _wide_product(p.T, dout[:, ih], dtype)
        dk[:, kvh] += _wide_product(ds.T, q[:, ih], dtype) / d ** 0.5
    return tuple(pack(x) for x in (dq, dk, dv)), ds_max


@functools.cache
def _wide_case(dtype, head_dim, window, s=256, h=4, kvh=2):
    """Inputs of ``dtype`` at S = ``s`` (``h`` query heads, ``kvh`` KV
    heads; by default 256, 4 and 2), held in f32, causal and, when given,
    over a window; lse and delta from an f64 forward, rounded to f32; dq,
    dk, dv recomputed in f64; the keep mask; and the kernels' bound on
    |dS|, 2 max_i |dO_i| max_j |v_j|."""
    d = head_dim
    rng = np.random.default_rng(23)
    rnd = _ROUND[dtype]
    q, dout = (rnd(torch.from_numpy(rng.standard_normal((s, h, d))).float())
               for _ in range(2))
    k, v = (rnd(torch.from_numpy(rng.standard_normal((s, kvh, d))).float())
            for _ in range(2))
    pos = torch.arange(s)
    keep = pos[:, None] >= pos[None, :]
    if window is not None:
        keep &= pos[:, None] - pos[None, :] < window
    group = h // kvh
    kf, vf = (x.double().repeat_interleave(group, dim=1).permute(1, 0, 2)
              for x in (k, v))
    qf, dof = q.double().permute(1, 0, 2), dout.double().permute(1, 0, 2)
    sc = (qf @ kf.transpose(1, 2) / d ** 0.5).masked_fill(~keep, -torch.inf)
    lse = torch.logsumexp(sc, dim=-1)
    p = torch.exp(sc - lse[..., None])
    delta = (dof * (p @ vf)).sum(-1)
    ds = p * (dof @ vf.transpose(1, 2) - delta[..., None])
    dk = (ds.transpose(1, 2) @ qf / d ** 0.5).reshape(
        kvh, group, s, d).sum(1).permute(1, 0, 2)
    dv = (p.transpose(1, 2) @ dof).reshape(kvh, group, s, d).sum(
        1).permute(1, 0, 2)
    dq = (ds @ kf / d ** 0.5).permute(1, 0, 2)
    bound = 2 * dout.norm(dim=-1).max().item() * v.norm(dim=-1).max().item()
    inputs = (q, k, v, dout, lse.float(), delta.float(), keep.float())
    return inputs, (dq, dk, dv), bound


@pytest.mark.parametrize("window", [None, 32], ids=["causal", "window"])
@pytest.mark.parametrize("head_dim", [512, 576])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_wide_bwd_slice_sums_stay_inside_the_bounds(dtype, head_dim, window):
    """The wide route's arithmetic (partial scores per 128-column depth
    slice summed in rank order, P and dS packed where the kernels pack
    them), at head_dim 512 and 576 (a ragged last slice of 64 columns),
    causal and over a window: against an f64 recomputation from the same
    inputs, dq, dk and dv stay inside the bound of their type, and |dS|
    inside its bound, far under f16's largest value."""
    inputs, want, bound = _wide_case(dtype, head_dim, window)
    got, ds_max = _wide_bwd_emulated(*inputs, dtype)
    errs = [((g.double() - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]
    assert max(errs) < WIDE_EMULATION_BOUND[dtype], errs
    assert ds_max <= bound < F16_MAX / 10, (ds_max, bound)


# ---------------------------------------------------------------------------
# The arithmetic of the backward kernels' head_dim-256 instances (head_dim
# 129-256: flash_bwd_dq_split_kernel, flash_bwd_dkv_split_kernel),
# emulated. Each score product runs once over the full depth (3xTF32 for
# f32); P and dS are packed where the kernels pack them (16-bit types)
# before dQ += dS K, dV += P^T dO and dK += dS^T Q, which add one tile at
# a time (KV tiles for dq, query tiles for dk and dv); and the parts of a
# KV tile (dkv_parts(): blocks that each take a share of the GQA group's
# query heads) add their f32 partial dk and dv in rank order.
# ---------------------------------------------------------------------------

#: an H100's SMs, for the parts the dk/dv launcher takes there
H100_SMS = 132
#: rows of the tiles the products add one at a time (dk/dv's query
#: tiles, dq's KV tiles), by input type
_SPLIT_ROWS = {"float32": 32, "float16": 64, "bfloat16": 64}


def _tile_sum(a, b, rows, dtype):
    """a @ b over the depth a tile of ``rows`` at a time, each tile's
    product added to the running f32 sum."""
    total = torch.zeros(a.shape[0], b.shape[1])
    for c in range(0, a.shape[1], rows):
        total = total + _wide_product(a[:, c:c + rows], b[c:c + rows],
                                      dtype)
    return total


def _split_bwd_emulated(q, k, v, dout, lse, delta, keep, dtype, parts):
    """(dq, dk, dv) of the 256 instances and the largest |dS| they pack,
    from f32 tensors holding values of ``dtype``; ``keep`` (query, key);
    ``parts`` blocks a KV tile of dk/dv, part r taking the group's query
    heads [r group / parts, (r + 1) group / parts)."""
    s, h, d = q.shape
    kvh = k.shape[1]
    group = h // kvh
    pack, rows = _ROUND[dtype], _SPLIT_ROWS[dtype]
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    ds_max = 0.0
    for j in range(kvh):
        kh, vh = k[:, j], v[:, j]
        part_k = [torch.zeros_like(kh) for _ in range(parts)]
        part_v = [torch.zeros_like(vh) for _ in range(parts)]
        for ih in range(group):
            rank = next(r for r in range(parts)
                        if ih < (r + 1) * group // parts)
            head = j * group + ih
            p = torch.exp(_wide_product(q[:, head], kh.T, dtype) / d ** 0.5
                          - lse[head][:, None]) * keep
            ds = p * (_wide_product(dout[:, head], vh.T, dtype)
                      - delta[head][:, None])
            ds_max = max(ds_max, ds.abs().max().item())
            p, ds = pack(p), pack(ds)
            dq[:, head] = _tile_sum(ds, kh, rows, dtype) / d ** 0.5
            part_v[rank] += _tile_sum(p.T, dout[:, head], rows, dtype)
            part_k[rank] += _tile_sum(ds.T, q[:, head], rows, dtype)
        sum_k, sum_v = torch.zeros_like(kh), torch.zeros_like(vh)
        for r in range(parts):
            sum_k, sum_v = sum_k + part_k[r], sum_v + part_v[r]
        dk[:, j], dv[:, j] = sum_k / d ** 0.5, sum_v
    return tuple(pack(x) for x in (dq, dk, dv)), ds_max


@pytest.mark.parametrize("window", [None, 32], ids=["causal", "window"])
@pytest.mark.parametrize("head_dim", [160, 256])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_split_bwd_arithmetic_stays_inside_the_bounds(dtype, head_dim,
                                                      window):
    """The 256 instances' arithmetic (full-depth scores computed once, P
    and dS packed where the kernels pack them, dk and dv summed over the
    parts the launcher takes on an H100 in rank order), at head_dim 160
    and 256, causal and over a window: against an f64 recomputation from
    the same inputs, dq, dk and dv stay inside the bound of their type,
    and |dS| inside its bound, far under f16's largest value."""
    inputs, want, bound = _wide_case(dtype, head_dim, window)
    s, h, _ = inputs[0].shape
    kvh = inputs[1].shape[1]
    parts = fa.dkv_parts(s, kvh, h // kvh, H100_SMS)
    assert parts > 1          # the parts' sum is part of what is held
    got, ds_max = _split_bwd_emulated(*inputs, dtype, parts)
    errs = [((g.double() - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]
    assert max(errs) < WIDE_EMULATION_BOUND[dtype], errs
    assert ds_max <= bound < F16_MAX / 10, (ds_max, bound)


@pytest.mark.parametrize("s, kv_heads, group, want", [
    (8192, 8, 1, 1),       # MHA: every block owns its KV tile alone
    (1000, 1, 1, 1),
    (8192, 8, 8, 1),       # the grid (1024 blocks) fills the card
    (16384, 2, 4, 1),      # 512 blocks
    (8192, 1, 8, 2),       # Gemma-2B's widths: 128 blocks for 132 SMs
    (8192, 1, 3, 2),       # a group that is not a power of two
    (2048, 1, 8, 8),       # 32 KV tiles: 8 parts, the most
    (333, 1, 8, 8),        # chip_smoke.py's edge_d200_gqa8_ragged_f16
    (256, 2, 2, 2),        # the emulation's shape: the group's 2 heads
])
def test_dkv_parts_fill_the_card(s, kv_heads, group, want):
    """The blocks that share a KV tile of the dk/dv kernel's 256
    instance on an H100: 1 under MHA and where the grid fills the card,
    above 1 where one KV head leaves SMs idle."""
    assert fa.dkv_parts(s, kv_heads, group, H100_SMS) == want


def test_dkv_parts_never_exceed_the_group():
    """parts is a power of two, at most the GQA group and 8 (a cluster's
    portable size), doubled only while the grid had no more blocks than
    the card has SMs."""
    for group in range(1, 17):
        for s in (1, 64, 65, 1000, 8192, 65536):
            for kv_heads in (1, 2, 8):
                for sms in (1, 78, 132):
                    parts = fa.dkv_parts(s, kv_heads, group, sms)
                    assert 1 <= parts <= min(group, 8)
                    assert parts & (parts - 1) == 0
                    tiles = -(-s // 64) * kv_heads
                    assert parts == 1 or tiles * parts // 2 <= sms


# ---------------------------------------------------------------------------
# The arithmetic of the backward kernels' wgmma route (bf16 and f16 at
# head_dim 33-256: flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel),
# emulated: the score products of 16-bit values summed in f32, P in base 2
# (lse times log2 e) and dS in f32, both packed to the input's type as the
# A operands of dQ += dS K (dq's KV tiles of the keys BWD_DQ_WGMMA_TILES
# gives the head_dim's padded width, added in order), dV += P^T dO and dK
# += dS^T Q (dk/dv's query tiles of the rows BWD_DKV_WGMMA_TILES gives it,
# every query head of a part's share of the GQA group in turn, into one
# running f32 sum; at 256 the parts of a KV tile, dkv_parts() on an H100,
# then added in rank order, as the 256 instances' are); dk's scale
# applied in f32 and each gradient rounded once.
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
#: chip_smoke.py's BWD_TOL, max abs error over max |gradient|
WGMMA_BWD_TOL = {"float16": F16_BWD_TOL, "bfloat16": 3e-2}


def _wgmma_bwd_emulated(q, k, v, dout, lse, delta, keep, dtype):
    """(dq, dk, dv) of the backward wgmma route and the largest |dS| it
    packs, from f32 tensors holding values of ``dtype``; ``keep`` (query,
    key) as 0 and 1."""
    s, h, d = q.shape
    kvh = k.shape[1]
    group = h // kvh
    pack = _ROUND[dtype]
    width = fa.bwd_wgmma_width(d)
    dq_keys = fa.BWD_DQ_WGMMA_TILES[width][1]
    dkv_rows = fa.BWD_DKV_WGMMA_TILES[width][1]
    parts = fa.dkv_parts(s, kvh, group, H100_SMS) if width == 256 else 1
    scale = d ** -0.5
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    dq = torch.empty_like(q)
    dk, dv = torch.zeros_like(k), torch.zeros_like(v)
    ds_max = 0.0
    for j in range(kvh):
        kh, vh = k[:, j], v[:, j]
        sum_k, sum_v = torch.zeros_like(kh), torch.zeros_like(vh)
        for r in range(parts):
            acc_k, acc_v = torch.zeros_like(kh), torch.zeros_like(vh)
            for ih in range(r * group // parts, (r + 1) * group // parts):
                head = j * group + ih
                lse2 = lse[head] * torch.tensor(LOG2E, dtype=torch.float32)
                p = torch.exp2(q[:, head] @ kh.T * scale_log2
                               - lse2[:, None]) * keep
                ds = p * (dout[:, head] @ vh.T - delta[head][:, None])
                ds_max = max(ds_max, ds.abs().max().item())
                p, ds = pack(p), pack(ds)
                dq[:, head] = _tile_sum(ds, kh, dq_keys, dtype) * scale
                for c in range(0, s, dkv_rows):
                    rows = slice(c, c + dkv_rows)
                    acc_v = acc_v + p[rows].T @ dout[rows, head]
                    acc_k = acc_k + ds[rows].T @ q[rows, head]
            sum_k, sum_v = sum_k + acc_k, sum_v + acc_v
        dk[:, j], dv[:, j] = sum_k * scale, sum_v
    return tuple(pack(x) for x in (dq, dk, dv)), ds_max


@pytest.mark.parametrize("window", [None, 32], ids=["causal", "window"])
@pytest.mark.parametrize("head_dim", [40, 64, 96, 128, 160, 256])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_bwd_wgmma_arithmetic_stays_inside_the_chip_bounds(dtype, head_dim,
                                                           window):
    """The backward wgmma route's order of sums (each padded width's tiles
    from BWD_DQ_WGMMA_TILES and BWD_DKV_WGMMA_TILES: dq's 128-key tiles at
    33-64, 64-key ones at 65-128 and 32-key ones at 129-256, dk/dv's
    64-row query tiles, P^T and dS^T packed to the input's type before the
    dV, dK and dQ products) at S = 512, head_dim 40, 64, 96 and 128 over a
    GQA group of 4, and 160 and 256 over Gemma's group of 8, whose dk and
    dv the launcher splits over 8 parts of a KV tile on an H100, summed in
    rank order; causal and over a window: against an f64 recomputation
    from the same inputs, dq, dk and dv stay within chip_smoke.py's
    BWD_TOL of their type, and |dS| within its bound, far under f16's
    largest value."""
    kvh = 1 if head_dim > 128 else 2
    inputs, want, bound = _wide_case(dtype, head_dim, window, s=512, h=8,
                                     kvh=kvh)
    if head_dim > 128:        # the parts' sum is part of what is held
        assert fa.dkv_parts(512, kvh, 8 // kvh, H100_SMS) == 8
    got, ds_max = _wgmma_bwd_emulated(*inputs, dtype)
    errs = [((g.double() - w).abs().max() / w.abs().max()).item()
            for g, w in zip(got, want)]
    assert max(errs) < WGMMA_BWD_TOL[dtype], errs
    assert ds_max <= bound < F16_MAX / 10, (ds_max, bound)


# (head_dim, dtype, whole 16-byte units, route): the backward wgmma route
# takes only bf16 and f16 at head_dim 33-256 whose q, k, v and dO are
# whole 16-byte units
BWD_ROUTE_TABLE = [
    (32, torch.bfloat16, True, "instance"),
    (32, torch.float16, False, "instance"),
    (33, torch.bfloat16, True, "wgmma"),
    (33, torch.float16, False, "instance"),
    (40, torch.bfloat16, True, "wgmma"),
    (40, torch.float16, True, "wgmma"),
    (40, torch.bfloat16, False, "instance"),
    (64, torch.bfloat16, True, "wgmma"),
    (64, torch.float16, True, "wgmma"),
    (64, torch.float16, False, "instance"),
    (64, torch.float32, True, "instance"),
    (65, torch.bfloat16, False, "instance"),   # 130-byte rows
    (128, torch.float16, True, "wgmma"),
    (256, torch.bfloat16, True, "wgmma"),
    (257, torch.bfloat16, True, "wide"),
    (1024, torch.float32, True, "wide"),
    (1025, torch.float16, True, "stream"),
    (72, torch.bfloat16, True, "wgmma"),
    (96, torch.float16, True, "wgmma"),
    (128, torch.bfloat16, True, "wgmma"),
    (128, torch.bfloat16, False, "instance"),
    (128, torch.float32, True, "instance"),
    (129, torch.bfloat16, True, "wgmma"),
    (160, torch.float16, True, "wgmma"),
    (200, torch.bfloat16, True, "wgmma"),
    (256, torch.float16, True, "wgmma"),
    (256, torch.bfloat16, False, "instance"),
    (256, torch.float32, True, "instance"),
    (196, torch.bfloat16, False, "instance"),  # 392-byte rows
]


@pytest.mark.parametrize("head_dim,width", [(33, 64), (64, 64), (65, 128),
                                            (96, 128), (128, 128), (129, 256),
                                            (256, 256)])
def test_bwd_wgmma_width(head_dim, width):
    """The padded width of the backward kernels' wgmma templates at each
    edge of their three (both sources' dq_for and dkv_for pad the same).
    That width's tiles, BWD_DQ_WGMMA_TILES and BWD_DKV_WGMMA_TILES, are
    held to the libraries' own (flash_bwd_dq_wgmma_tiles,
    flash_bwd_dkv_wgmma_tiles) by chip_smoke.py's build phase."""
    assert fa.bwd_wgmma_width(head_dim) == width


@pytest.mark.parametrize("head_dim,dtype,aligned,route", BWD_ROUTE_TABLE)
def test_bwd_route_table(head_dim, dtype, aligned, route):
    """Which route of the backward kernels each (head_dim, dtype, whole
    16-byte units) takes; chip_smoke.py holds both launchers' own answers
    (flash_bwd_dq_route, flash_bwd_dkv_route) to bwd_route at every shape
    it launches."""
    assert fa.bwd_route(head_dim, dtype, aligned) == route
    assert route in fa.BWD_ROUTES


class _EmulatedFlash(torch.autograd.Function):
    """bf16 or f16 causal attention through the emulated arithmetic of the
    kernels a 16-bit TinyLM at head_dim 33-256 runs on the card: the
    forward's wgmma route (its tiles at the head_dim's padded width, P
    packed to the input's type before P V) and the backward's."""

    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = _fwd_wgmma_emulated(q.float(), k.float(), v.float(),
                                     q.dtype, None)
        out = o.to(q.dtype)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        delta = fa.flash_bwd_delta(out, dout)
        s = q.shape[0]
        keep = torch.ones(s, s).tril()
        dtype = str(q.dtype).removeprefix("torch.")
        grads, _ = _wgmma_bwd_emulated(q.float(), k.float(), v.float(),
                                       dout.float(), lse, delta, keep, dtype)
        return tuple(g.to(x.dtype) for g, x in zip(grads, (q, k, v)))


#: (chip_smoke.LLAMA_PHASES' phase, TinyLM config) whose bounds each case
#: of test_llama_lm_bound_covers_the_kernels_bf16_arithmetic derives, by
#: head_dim: Llama-3.2-1B's (64) and Meta-Llama-3-8B's (128), each with
#: its GQA group of 4, and Gemma-2B's (256) with one KV head, narrow
LLAMA_BOUND_CASES = {
    64: ("llama_lm", dict(vocab=256, dim=512, heads=8, kv_heads=2,
                          pos="rope", mlp_mult=4, max_seq=512, layers=2)),
    128: ("llama8b_lm", dict(vocab=256, dim=512, heads=4, kv_heads=1,
                             pos="rope", mlp_mult=4, max_seq=512, layers=2)),
    256: ("gemma_bf16_lm", dict(vocab=256, dim=512, heads=2, kv_heads=1,
                                pos="rope", mlp_mult=8, max_seq=512,
                                layers=2)),
}


@pytest.mark.parametrize("head_dim", list(LLAMA_BOUND_CASES))
def test_llama_lm_bound_covers_the_kernels_bf16_arithmetic(head_dim):
    """Derives chip_smoke.py's bounds of the bf16 TinyLM phases
    (LLAMA_PHASES: LLAMA_LOSS_TOL and LLAMA_GRAD_TOL at head_dim 64,
    LLAMA8B_LOSS_TOL and LLAMA8B_GRAD_TOL at 128, GEMMA_BF16_LOSS_TOL and
    GEMMA_BF16_GRAD_TOL at 256): a bf16 TinyLM at the
    phase's head_dim and GQA group (4; 2 at 256), narrow (at 64 dim 512, 8
    heads, 2 KV heads; at 128 dim 512, 4 heads, 1 KV head; at 256 dim 512,
    2 heads, 1 KV head; 2 layers) at S 512,
    through the emulated arithmetic of the kernels it runs on the card
    (_EmulatedFlash) against the same weights on the kernels' plain
    versions (the flash plane on the CPU). Measured at 64 with the
    forward's wgmma tiles: the loss moves by 9.5e-6 and a parameter's
    gradient by at most 0.995% of its largest (3.2e-5 and 1.05% at dim
    256, S 512; 6.3e-5 and 1.15% at dim 512, S 1024; wo's or the
    embedding's); with the instance's tiles before, 1.1e-4 and 1.12%
    (1.7% at dim 256). At 128, with both routes' head_dim-128 tiles:
    6.7e-6 and 1.09% (blocks.1.wq's). At 256 (Gemma's one KV head; dim
    512, 2 heads), with the forward's 80-key tiles and the backward's
    32-key dq tiles and summed dk/dv parts: 1.7e-4 and 1.15% (embed's).
    The bounds leave ten times the largest on the loss and twice on the
    gradients for the card's full width at S 2048, whose sums are
    longer."""
    from unittest import mock

    import chip_smoke
    from fiber_tpu_torch.models import transformer
    from fiber_tpu_torch.models.transformer import TinyLM

    phase, cfg = LLAMA_BOUND_CASES[head_dim]
    assert cfg["dim"] // cfg["heads"] == head_dim
    _, loss_tol, grad_tol = chip_smoke.LLAMA_PHASES[phase]
    tokens = torch.randint(0, cfg["vocab"], (cfg["max_seq"],),
                           generator=torch.Generator().manual_seed(9))
    legs = {"kernels": lambda q, k, v, *, causal, window:
            _EmulatedFlash.apply(q, k, v),
            "plain": fa.flash_attention}
    losses, grads = {}, {}
    for leg, attention in legs.items():
        with mock.patch.object(transformer, "flash_attention", attention):
            model = TinyLM(**cfg, attention="flash", device="cpu",
                           dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(0))
            loss = model.loss(tokens)
            loss.backward()
        losses[leg] = loss.item()
        grads[leg] = {n: p.grad.float() for n, p in model.named_parameters()}
    loss_err = abs(losses["kernels"] - losses["plain"])
    rel = max(((grads["kernels"][n] - g).abs().max() / g.abs().max()).item()
              for n, g in grads["plain"].items())
    assert 0 < loss_err < loss_tol / 10, loss_err
    assert 0 < rel < grad_tol / 2, rel
