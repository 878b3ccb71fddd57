"""The port's flash-attention backward (the autograd Function over the
plain versions of the dq and dk/dv kernels, on the CPU) against
``jax.grad`` through the JAX package's Pallas kernels in interpret mode.

Tolerance: max abs error over max |want| below 2e-5 in f32 (two f32
recurrences whose sums run in different orders) and 3e-2 in bf16 (inputs,
outputs and gradients rounded to bf16 at different places), the forward
tests' bounds.
"""

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
    # the bounds the kernels are held to at the LM's shape, f32 peak
    dq = flops.attention_bwd_flops(16384, 8, 32, part="dq")
    assert flops.bound_ms(dq, 0, "float32")[0] == pytest.approx(3.077,
                                                                abs=1e-3)
