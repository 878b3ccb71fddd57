"""Analytic operation counts and the H100's published peaks.

The counters are a copy of ``fiber_tpu/utils/flops.py``
(``matmul_flops``, ``attention_flops``, ``tinylm_flops_per_step``) under
the same conventions: a (m, k) x (k, n) product is ``2*m*k*n``
operations, attention counts its two S x S products (causal halves them,
a window counts each row's min(pos+1, window) keys), softmax is not
counted, and training is 3x the forward.

The peaks are one NVIDIA H100 SXM's, dense, from NVIDIA's data sheet;
they assume the card's full 700 W power limit. :func:`bound_ms` is the
least time the card could take for a piece of work: the larger of its
bytes over the memory rate and its operations over the peak of the type
that does them.
"""

from __future__ import annotations

from typing import Optional

#: peak operations per second by the type that does them
H100_PEAK_FLOPS = {
    "float32": 67e12,     # CUDA-core FMA, outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
}
#: HBM3 bytes per second
H100_MEM_BYTES_PER_S = 3.35e12


def matmul_flops(m: int, k: int, n: int) -> float:
    return 2.0 * m * k * n


def attention_flops(seq: int, heads: int, head_dim: int,
                    causal: bool = True, train: bool = False,
                    window: Optional[int] = None) -> float:
    """QK^T + P.V for one head stack at full sequence length. With a
    causal sliding ``window`` each position attends min(pos+1, window)
    keys instead of pos+1."""
    if window is not None:
        if not causal:
            raise ValueError("windowed attention_flops requires causal")
        w = min(window, seq)
        kv_total = w * (w + 1) / 2 + (seq - w) * w
        fwd = 2 * 2 * kv_total * head_dim * heads
        return fwd * (3.0 if train else 1.0)
    fwd = 2 * matmul_flops(seq, head_dim, seq) * heads
    if causal:
        fwd /= 2
    return fwd * (3.0 if train else 1.0)


def attention_bwd_flops(seq: int, heads: int, head_dim: int,
                        causal: bool = True, window: Optional[int] = None,
                        part: str = "dq") -> float:
    """Operations of one backward kernel, for its bound: only the S x S x
    D products its function needs, counted, halved by causality and
    windowed as :func:`attention_flops` counts the forward's two. ``dq``
    needs s, dp and dq (3 products, 1.5x the forward); ``dkv`` needs s,
    dp, dv and dk (4 products, 2x the forward). The exponentials and the
    elementwise ds are not counted, as softmax is not in the forward.
    :func:`tinylm_flops_per_step` keeps the JAX package's 3x convention
    for model FLOP/s instead."""
    products = {"dq": 3, "dkv": 4}[part]
    return attention_flops(seq, heads, head_dim, causal=causal,
                           window=window) * products / 2


def tinylm_flops_per_step(model, seq: int, train: bool = True) -> float:
    """One TinyLM forward (or train: fwd + 2x bwd) at ``seq`` tokens:
    the per-block projections, attention and the unembedding."""
    d, h = model.dim, model.mlp_mult * model.dim
    kvh = getattr(model, "kv_heads", model.heads)
    if kvh == model.heads:
        proj = matmul_flops(seq, d, 3 * d)
    else:
        kv_dim = kvh * model.head_dim
        proj = matmul_flops(seq, d, d) + matmul_flops(seq, d, 2 * kv_dim)
    per_block = (
        proj
        + matmul_flops(seq, d, d)
        + matmul_flops(seq, d, h)
        + matmul_flops(seq, h, d)
        + attention_flops(seq, model.heads, model.head_dim, causal=True,
                          window=getattr(model, "window", None))
    )
    fwd = model.layers * per_block + matmul_flops(seq, d, model.vocab)
    return fwd * (3.0 if train else 1.0)


def bound_ms(flops: float, nbytes: float, op_type: str):
    """(least time in ms, "bytes" or "operations") for work of ``flops``
    operations of ``op_type`` that must move ``nbytes``."""
    t_ops = flops / H100_PEAK_FLOPS[op_type]
    t_mem = nbytes / H100_MEM_BYTES_PER_S
    if t_ops >= t_mem:
        return t_ops * 1e3, "operations"
    return t_mem * 1e3, "bytes"
