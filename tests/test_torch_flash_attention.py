"""The port's flash-attention forward (plain version, on the CPU) against
the JAX package's Pallas kernels run in interpret mode, and the port's
reference attention against the JAX reference.

Tolerances are the JAX package's own (tests/test_pallas_attention.py):
2e-5 in f32 (two f32 online softmaxes in different orders), 3e-2 in
bf16 (one rounding of inputs and outputs to bf16); in f16, whose inputs
both sides take as they are and whose outputs both round once from f32,
4e-3 (one f16 ulp at |o| < 8).
"""

import functools
import math

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


#: the torch dtype of each JAX dtype the cases use
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
                jnp.float16: torch.float16}


def _both(arrays, dtype):
    jx = tuple(jnp.asarray(a, dtype) for a in arrays)
    tx = tuple(torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays)
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
    # every dtype and head_dim the Pallas kernels take: f16, and head_dims
    # past 128 (the kernels' 256 instance), causal with GQA and a window
    "f16_gqa_window": (128, 4, 2, 64, True, 40, 64, 64, jnp.float16, 4e-3),
    "d256_gqa_window": (128, 4, 2, 256, True, 40, 64, 64, jnp.float32,
                        2e-5),
    "bf16_d160_gqa_window": (128, 4, 2, 160, True, 40, 64, 64,
                             jnp.bfloat16, 3e-2),
    "bf16_d192_gqa_window": (128, 4, 2, 192, True, 40, 64, 64,
                             jnp.bfloat16, 3e-2),
    # head_dims past 256 (the kernels' wide route on the card): 300 with
    # a ragged S, 512 with GQA 8:1 and a window (DeepSeek-V4-Flash's
    # head), 576 not causal (sarvam-105b's head_dim), and one bf16 and
    # one f16 case
    "d300_ragged": (100, 2, 1, 300, True, None, 64, 64, jnp.float32, 2e-5),
    "d512_gqa8_window": (64, 8, 1, 512, True, 16, 64, 64, jnp.float32,
                         2e-5),
    "d576_noncausal": (96, 2, 2, 576, False, None, 64, 64, jnp.float32,
                       2e-5),
    "bf16_d384_gqa_window": (128, 4, 2, 384, True, 40, 64, 64,
                             jnp.bfloat16, 3e-2),
    "f16_d320_gqa": (96, 4, 1, 320, True, None, 64, 64, jnp.float16, 4e-3),
}
#: the f32 cases past head_dim 256, whose backward is also held with an
#: lse cotangent
WIDE_F32_CASES = ["d300_ragged", "d512_gqa8_window", "d576_noncausal"]


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


# ---------------------------------------------------------------------------
# The arithmetic of csrc/flash_fwd.cu on f16 inputs, emulated: per 64-key
# tile, S = Q K^T (products of f16 values, exact in f32, summed in f32),
# the online softmax in f32, P rounded to f16 (pack16 in mma_sm90.cuh)
# before P V, whose sums are f32, and O rounded to f16 once.
# ---------------------------------------------------------------------------

#: chip_smoke.py's TOL["float16"]: one f16 ulp at |o| < 8
F16_TOL = 4e-3


def _f16(x):
    """f32 values rounded to f16, to nearest, and held in f32."""
    return x.half().float()


def _fwd_emulated_f16(q, k, v, tile=64):
    """O (S, heads, D) of the kernel's f16 path, causal, from f32 tensors
    that hold f16 values."""
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
            sc = (qh @ kh[k0:k0 + tile].T / d ** 0.5).masked_fill(~keep,
                                                                  -1e30)
            m_new = torch.maximum(m, sc.amax(1, keepdim=True))
            p = torch.exp(sc - m_new) * keep
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(1, keepdim=True)
            o = o * corr + _f16(p) @ vh[k0:k0 + tile]
            m = m_new
        out[:, ih] = _f16(o / l)
    return out


@functools.cache
def _f16_case(head_dim):
    """f16 inputs at S = 2048 (4 query heads, 2 KV heads), held in f32, and
    causal attention recomputed from them in f64."""
    s, h, kvh = 2048, 4, 2
    q, k, v = (_f16(torch.from_numpy(a))
               for a in _qkv(s, h, kvh, head_dim, seed=17))
    kf, vf = (x.double().repeat_interleave(h // kvh, dim=1).permute(1, 0, 2)
              for x in (k, v))
    sc = q.double().permute(1, 0, 2) @ kf.transpose(1, 2) / head_dim ** 0.5
    sc = sc.masked_fill(~torch.ones(s, s, dtype=torch.bool).tril(),
                        -torch.inf)
    want = (torch.softmax(sc, dim=-1) @ vf).permute(1, 0, 2)
    return (q, k, v), want


@pytest.mark.parametrize("head_dim", [64, 256])
def test_fwd_f16_rounding_stays_inside_the_f16_bound(head_dim):
    """The forward kernel's f16 path rounds P to f16 before P V: against
    an f64 recomputation from the same f16 inputs, its emulated O stays
    inside the card's f16 bound (F16_TOL), of which the final rounding of
    O to f16 takes up to half."""
    inputs, want = _f16_case(head_dim)
    err = (_fwd_emulated_f16(*inputs).double() - want).abs().max().item()
    assert err < F16_TOL, err


# ---------------------------------------------------------------------------
# The arithmetic of csrc/flash_fwd.cu's wide route (flash_fwd_wide_kernel,
# head_dim 257-576), emulated: per KV tile (64 keys in a 16-bit type up to
# head_dim 512, else 32), S = Q K^T as one full-depth product (exact
# products summed in f32 for a 16-bit type; 3xTF32 for f32, summed in four
# interleaved partial products over the 8-column depth steps, then
# added), each row's max
# over the whole tile (the maxima of the warps that split its keys), P in
# base 2, l summed from those warps' parts in their order, P V with P
# packed to a 16-bit input's type (f32 as it is, its 3xTF32 product summed
# from zero and folded into O with one rounding), and O rounded once.
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
#: chip_smoke.py's TOL and LSE_TOL, by dtype
CHIP_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 4e-3}
CHIP_LSE_TOL = 1e-4


def _wide_tiles(dtype, d):
    """(keys a tile, warps an m-tile) of the wide route's template for
    ``dtype`` and head_dim ``d``."""
    if dtype == torch.float32:
        return 32, 4
    return (64 if d <= 512 else 32), 2


def _wide_f32_scores(q, k):
    """q @ k.T as the wide route computes it in f32: 3xTF32 products of
    depth steps 8kk..8kk+7 summed into partial a = kk mod 4, then
    (p0 + p1) + (p2 + p3)."""
    steps = torch.arange(q.shape[1]).view(-1, 8)
    p = [product(q[:, steps[a::4].flatten()], k[:, steps[a::4].flatten()].T,
                 "3xtf32") for a in range(4)]
    return (p[0] + p[1]) + (p[2] + p[3])


def _causal_keep(s, window, k0=0, n=None):
    pos = torch.arange(s)
    diff = pos[:, None] - pos[None, k0:None if n is None else k0 + n]
    keep = diff >= 0
    if window is not None:
        keep &= diff < window
    return keep


def _fwd_wide_emulated(q, k, v, dtype, window):
    """(O, lse) of the wide route, causal, from f32 tensors that hold
    ``dtype`` values; S a whole number of KV tiles."""
    s, h, d = q.shape
    group = h // k.shape[1]
    bkv, wpm = _wide_tiles(dtype, d)
    f32 = dtype == torch.float32
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    out, lse = torch.empty_like(q), torch.empty(h, s)
    for ih in range(h):
        qh, kh, vh = q[:, ih], k[:, ih // group], v[:, ih // group]
        m = torch.full((s, 1), -1e30)
        l = torch.zeros(s, 1)
        o = torch.zeros(s, d)
        for k0 in range(0, s, bkv):
            keep = _causal_keep(s, window, k0, bkv)
            kt, vt = kh[k0:k0 + bkv], vh[k0:k0 + bkv]
            raw = _wide_f32_scores(qh, kt) if f32 else qh @ kt.T
            raw = raw.masked_fill(~keep, -1e30)
            m_new = torch.maximum(m, raw.amax(1, keepdim=True) * scale_log2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(raw * scale_log2 - m_new) * keep
            parts = p.view(s, wpm, bkv // wpm).sum(-1)
            ls = torch.zeros(s, 1)
            for w in range(wpm):
                ls = ls + parts[:, w:w + 1]
            l = l * corr + ls
            if f32:
                pv = product(p, vt, "3xtf32")
                o = (o.double() * corr.double() + pv.double()).float()
            else:
                o = o * corr + p.to(dtype).float() @ vt
            m = m_new
        li = torch.where(l == 0, torch.ones_like(l), l)
        out[:, ih] = o / li
        lse[ih] = (m * math.log(2) + torch.log(li))[:, 0]
    return out.to(dtype).float(), lse


@functools.cache
def _wide_case(dtype, head_dim, window):
    """Inputs of ``dtype`` at S = 512 (2 query heads, 1 KV head), held in
    f32, and (O, lse) recomputed from them in f64."""
    s, h = 512, 2
    q, k, v = (torch.from_numpy(a).to(dtype).float()
               for a in _qkv(s, h, 1, head_dim, seed=19))
    sc = (q.double().permute(1, 0, 2) @ k.double()[:, 0].T) / head_dim ** 0.5
    sc = sc.masked_fill(~_causal_keep(s, window), -torch.inf)
    want = (torch.softmax(sc, dim=-1) @ v.double()[:, 0]).permute(1, 0, 2)
    return (q, k, v), want, torch.logsumexp(sc, dim=-1)


@pytest.mark.parametrize("window", [None, 128], ids=["causal", "window128"])
@pytest.mark.parametrize("head_dim", [512, 576])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
def test_fwd_wide_arithmetic_stays_inside_the_chip_bounds(dtype, head_dim,
                                                          window):
    """The wide route's order of sums (full-depth scores, row maxima and
    sums over the warps that split a tile's keys, P packed where the kernel
    packs it) against an f64 recomputation from the same inputs: O under a
    tenth of chip_smoke.py's f32 TOL in f32, under F16_TOL in f16 and the
    bf16 TOL in bf16, and lse under LSE_TOL."""
    inputs, want, want_lse = _wide_case(dtype, head_dim, window)
    o, lse = _fwd_wide_emulated(*inputs, dtype, window)
    bound = {torch.float32: CHIP_TOL[torch.float32] / 10,
             torch.float16: F16_TOL,
             torch.bfloat16: CHIP_TOL[torch.bfloat16]}[dtype]
    err = (o.double() - want).abs().max().item()
    assert err < bound, err
    lse_err = (lse.double() - want_lse).abs().max().item()
    assert lse_err < CHIP_LSE_TOL, lse_err


# ---------------------------------------------------------------------------
# The arithmetic of csrc/flash_fwd.cu's wgmma route (flash_fwd_wgmma_kernel,
# bf16 and f16 at head_dim 33-256), emulated: per query tile and each of its
# KV tiles (FWD_WGMMA_TILES of the head_dim's padded width, which
# chip_smoke.py's build holds to the library's; the causal end and the
# window's start taken from the query tile), S = Q K^T (exact
# products of 16-bit values summed in f32), the online softmax in base 2, O
# rescaled by corr, P packed to the input's type and O += P V in f32, and O
# rounded once.
# ---------------------------------------------------------------------------


def _fwd_wgmma_emulated(q, k, v, dtype, window, tiles=None):
    """(O, lse) of the wgmma route, causal, from f32 tensors that hold
    ``dtype`` values; ``tiles`` (query rows, keys) of another route whose
    arithmetic is the same (the 16-bit instances: 128 query rows and 64
    keys up to head_dim 64), by default the wgmma route's at this
    head_dim."""
    bq, bkv = tiles or fa.FWD_WGMMA_TILES[fa.fwd_wgmma_width(q.shape[2])]
    s, h, d = q.shape
    group = h // k.shape[1]
    scale_log2 = torch.tensor(d ** -0.5 * LOG2E, dtype=torch.float32)
    out, lse = torch.empty_like(q), torch.empty(h, s)
    for ih in range(h):
        kh, vh = k[:, ih // group], v[:, ih // group]
        for q0 in range(0, s, bq):
            q1 = min(s, q0 + bq)
            kv_begin = 0
            if window is not None and q0 - window + 1 > 0:
                kv_begin = (q0 - window + 1) // bkv * bkv
            m = torch.full((q1 - q0, 1), -1e30)
            l = torch.zeros(q1 - q0, 1)
            o = torch.zeros(q1 - q0, d)
            for k0 in range(kv_begin, q1, bkv):
                k1 = min(s, k0 + bkv)
                keep = _causal_keep(s, window, k0, k1 - k0)[q0:q1]
                raw = (q[q0:q1, ih] @ kh[k0:k1].T).masked_fill(~keep, -1e30)
                m_new = torch.maximum(m, raw.amax(1, keepdim=True)
                                      * scale_log2)
                corr = torch.exp2(m - m_new)
                p = torch.exp2(raw * scale_log2 - m_new) * keep
                l = l * corr + p.sum(1, keepdim=True)
                o = o * corr + p.to(dtype).float() @ vh[k0:k1]
                m = m_new
            li = torch.where(l == 0, torch.ones_like(l), l)
            out[q0:q1, ih] = o / li
            lse[ih, q0:q1] = (m * math.log(2) + torch.log(li))[:, 0]
    return out.to(dtype).float(), lse


@pytest.mark.parametrize("window", [None, 128], ids=["causal", "window128"])
@pytest.mark.parametrize("head_dim", [40, 64, 96, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16],
                         ids=["f16", "bf16"])
def test_fwd_wgmma_arithmetic_stays_inside_the_chip_bounds(dtype, head_dim,
                                                           window):
    """The wgmma route's order of sums (each padded width's tiles from
    FWD_WGMMA_TILES: 128-key tiles at 33-64, 64-key at 65-128, 80-key at
    129-256; P packed to the input's type before P V) against an f64 recomputation
    from the same inputs at S = 512: O under F16_TOL in f16 and the bf16
    TOL in bf16, and lse under LSE_TOL."""
    inputs, want, want_lse = _wide_case(dtype, head_dim, window)
    o, lse = _fwd_wgmma_emulated(*inputs, dtype, window)
    bound = F16_TOL if dtype == torch.float16 else CHIP_TOL[torch.bfloat16]
    err = (o.double() - want).abs().max().item()
    assert err < bound, err
    lse_err = (lse.double() - want_lse).abs().max().item()
    assert lse_err < CHIP_LSE_TOL, lse_err


# (head_dim, dtype, aligned, route): the wgmma route takes only bf16 and
# f16 at head_dim 33-256 whose q, k and v are whole 16-byte units
FWD_ROUTE_TABLE = [
    (64, torch.bfloat16, True, "wgmma"),
    (128, torch.float16, True, "wgmma"),
    (40, torch.bfloat16, True, "wgmma"),
    (96, torch.float16, True, "wgmma"),
    (32, torch.bfloat16, True, "instance"),
    (64, torch.float32, True, "instance"),
    (96, torch.bfloat16, False, "instance"),
    (129, torch.bfloat16, True, "wgmma"),
    (136, torch.float16, True, "wgmma"),
    (192, torch.bfloat16, True, "wgmma"),
    (196, torch.bfloat16, False, "instance"),
    (256, torch.float16, True, "wgmma"),
    (256, torch.bfloat16, False, "instance"),
    (256, torch.float32, True, "instance"),
    (160, torch.float32, True, "instance"),
    (257, torch.bfloat16, True, "wide"),
    (576, torch.float16, True, "wide"),
    (577, torch.bfloat16, True, "stream"),
    (1024, torch.float32, True, "stream"),
]


@pytest.mark.parametrize("head_dim,dtype,aligned,route", FWD_ROUTE_TABLE)
def test_fwd_route_table(head_dim, dtype, aligned, route):
    """Which route of the forward kernel each (head_dim, dtype, whole
    16-byte units) takes; chip_smoke.py holds the launcher's own answer
    (flash_fwd_route) to fwd_route at every shape it launches."""
    assert fa.fwd_route(head_dim, dtype, aligned) == route
    assert route in fa.FWD_ROUTES


@pytest.mark.parametrize("head_dim,width", [(33, 64), (64, 64), (65, 128),
                                            (128, 128), (129, 256),
                                            (256, 256)])
def test_fwd_wgmma_width(head_dim, width):
    """The padded width of the forward's wgmma template at each edge of its
    three (csrc/flash_fwd.cu's fwd_for pads the same). That width's tiles,
    FWD_WGMMA_TILES, are held to the library's own
    (flash_fwd_wgmma_tiles) by chip_smoke.py's build phase."""
    assert fa.fwd_wgmma_width(head_dim) == width
