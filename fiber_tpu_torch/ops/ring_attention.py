"""Ring attention: exact attention over a sequence sharded across the
mesh, and the full-matrix reference attention that is its oracle.

Counterpart of ``fiber_tpu/ops/ring_attention.py``. Every rank owns a
query block and its KV block; the KV blocks rotate one step along the
mesh axis per round while every rank keeps an online-softmax
accumulator, so after n rounds each rank holds exact attention for its
queries and no rank ever holds the (S, S) scores. Causal masking uses
global positions (``rank * S/n + arange``), so it stays right as the
blocks rotate.

The mesh is single-controller (``parallel/mesh.py``): the JAX package's
per-device body is a loop over ranks here, and each rotation moves every
rank's K and V at once: through the ``ring_exchange`` kernel
(``ops/dma_ring.py``) when no block needs a gradient, else through
``ops/collectives.ppermute`` (plain copies, differentiable);
``use_dma_ring=True`` or ``False`` forces one. With ``local="flash"``
the per-rank block is the ``flash_fwd`` kernel; the JAX package's
``lax.cond`` three-way causal split becomes a Python branch on the rank
index, so a block that lies wholly in a rank's future launches nothing.
The JAX package's ``interpret=`` has no counterpart: the tensors'
device decides between kernels and their plain versions.

Data x sequence parallelism (``__graft_entry__.py``'s 2-D composition):
on a ``("data", "seq")`` grid mesh, :func:`ring_attention` takes
(B, S, heads, head_dim) inputs, gives every rank its (B/d, S/s) block,
and runs the per-rank body of each data row on that row's ``seq``
sub-mesh. The body folds a batched block into the heads, (b, S/s, h, d)
-> (S/s, b*h, d), so that one kernel launch serves the row's batch;
query head ``bi*h + j`` reads KV head ``bi*kvh + j // (h // kvh)``, the
same grouping as the unfolded block.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.ops.dma_ring import pick_ring, ring_exchange
from fiber_tpu_torch.ops.flash_attention import flash_attention_lse
from fiber_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    shard,
    shard_grid,
    unshard,
    unshard_grid,
)

#: elements of one (heads, rows, S) score tile of ``reference_attention``;
#: query rows are processed in chunks of at most this many scores, so
#: S = 16384 fits on one card
_CHUNK_ELEMS = 1 << 26
#: the most KV rows one rank scores against at once (tokens)
_KV_CHUNK = 1024
#: lse of a skipped block: its weight exp(-1e30 - m) in a merge is 0
_SKIP_LSE = -1e30
#: the axes of a data x sequence grid mesh
DATA_AXIS, SEQ_AXIS = "data", "seq"


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Softmax-statistic dtype: at least f32, never narrower than the
    input (f64 inputs keep f64 statistics)."""
    return torch.promote_types(dtype, torch.float32)


def _block_attn(q, k, mask):
    """Scores of one (query block, KV block) pair, (h, sq, skv) in the
    accumulator dtype, masked with that dtype's most negative finite
    value. q (sq, h, d), k (skv, h, d), mask (sq, skv) or None."""
    acc = _acc_dtype(q.dtype)
    s = torch.einsum("qhd,khd->hqk", q.to(acc), k.to(acc))
    s = s / torch.sqrt(torch.tensor(q.shape[-1], dtype=acc))
    if mask is not None:
        s = s.masked_fill(~mask[None], torch.finfo(acc).min)
    return s


def _accumulate_block(q_blk, q_pos, k_cur, v_cur, kv_pos0: int, m, l, o,
                      causal: bool, recompute: bool = True):
    """Online-softmax update of (m, l, o) with one KV block, taken in
    chunks of at most ``_KV_CHUNK`` rows (a ragged tail is one shorter
    chunk), so the score slab is bounded at (h, sq, _KV_CHUNK).

    q_blk (sq, h, d); k_cur, v_cur (skv, h, d); q_pos (sq,) global query
    positions; kv_pos0 the global position of k_cur[0]; m, l (h, sq) and
    o (sq, h, d) in the accumulator dtype. ``m`` starts at -inf; a fully
    masked chunk row keeps it there without NaNs.

    Under grad, autograd keeps only each chunk's inputs and recomputes
    its score slabs in backward (``torch.utils.checkpoint``): the same
    operations on the same values, so the same gradients bit for bit,
    without the three (h, sq, _KV_CHUNK) slabs a chunk would otherwise
    keep (27 GB a layer of TinyLM at S = 16384 on the ring plane).
    ``recompute=False`` keeps them, the reference the tests hold the
    recomputation to."""
    acc = _acc_dtype(q_blk.dtype)

    def one_chunk(k_c, v_c, kv0, m, l, o):
        mask = None
        if causal:
            kv_pos = kv0 + torch.arange(k_c.shape[0], device=q_pos.device)
            mask = q_pos[:, None] >= kv_pos[None, :]
        s = _block_attn(q_blk, k_c, mask)
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard -inf - -inf (fully masked rows) producing NaN
        m_safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - m_safe[..., None])
        if mask is not None:
            p = torch.where(mask[None], p, 0.0)
        corr = torch.where(torch.isinf(m), 0.0, torch.exp(m - m_safe))
        l_new = l * corr + p.sum(dim=-1)
        o_new = o * corr.transpose(0, 1)[:, :, None] + torch.einsum(
            "hqk,khd->qhd", p.to(v_c.dtype).to(acc), v_c.to(acc))
        return m_new, l_new, o_new

    recompute = recompute and torch.is_grad_enabled()
    skv = k_cur.shape[0]
    for c0 in range(0, skv, _KV_CHUNK):
        c1 = min(skv, c0 + _KV_CHUNK)
        args = (k_cur[c0:c1], v_cur[c0:c1], kv_pos0 + c0, m, l, o)
        if recompute:   # a chunk draws no random numbers: no RNG state
            m, l, o = checkpoint(one_chunk, *args, use_reentrant=False,
                                 preserve_rng_state=False)
        else:
            m, l, o = one_chunk(*args)
    return m, l, o


def _acc_init(q):
    """Fresh (m, l, o) for a (sq, h, d) query block: m at -inf, l and o
    zero, in the accumulator dtype."""
    sq, h, _ = q.shape
    acc = _acc_dtype(q.dtype)
    m0 = torch.full((h, sq), float("-inf"), dtype=acc, device=q.device)
    l0 = torch.zeros((h, sq), dtype=acc, device=q.device)
    o0 = torch.zeros(q.shape, dtype=acc, device=q.device)
    return m0, l0, o0


def _acc_finalize(o, l, out_dtype):
    """o / l, with fully masked rows (l == 0) left as zeros, cast to the
    caller's dtype."""
    l = torch.where(l == 0.0, 1.0, l)
    return (o / l.transpose(0, 1)[:, :, None]).to(out_dtype)


def blockwise_attention(q, k, v, causal: bool = False):
    """Exact single-rank attention with the score slab bounded at
    (h, sq, _KV_CHUNK): q, k, v (S, heads, head_dim), equal head counts.
    Differentiable, recomputing the slabs in backward."""
    q_pos = torch.arange(q.shape[0], device=q.device)
    m, l, o = _accumulate_block(q, q_pos, k, v, 0, *_acc_init(q), causal)
    return _acc_finalize(o, l, q.dtype)


def _merge_partials(o1, lse1, o2, lse2):
    """Exactly combine two partial attentions over disjoint KV sets:
    o (sq, h, d) f32, each normalised over its own set, and lse (h, sq)
    f32. A skipped part carries lse = -1e30 and weighs 0."""
    m = torch.maximum(lse1, lse2)
    w1 = torch.exp(lse1 - m)
    w2 = torch.exp(lse2 - m)
    denom = w1 + w2
    w1t = (w1 / denom).transpose(0, 1)[:, :, None]
    w2t = (w2 / denom).transpose(0, 1)[:, :, None]
    return o1 * w1t + o2 * w2t, m + torch.log(denom)


def _kv_rotate(k_cur, v_cur, mesh: Mesh, use_dma_ring: bool):
    """One rotation of every rank's K and V block: through the
    ``ring_exchange`` kernel (both arrays of every rank in one launch)
    with ``use_dma_ring``, else through plain copies."""
    if use_dma_ring:
        k_cur, v_cur = ring_exchange(
            [[x.contiguous() for x in blks] for blks in (k_cur, v_cur)],
            mesh)
        return k_cur, v_cur
    return (collectives.ppermute(k_cur, mesh),
            collectives.ppermute(v_cur, mesh))


def _ring_flash_local(q_blks, k_blks, v_blks, mesh: Mesh, causal: bool,
                      use_dma_ring: bool):
    """Ring attention with ``flash_fwd`` as the per-rank block: every
    rotation runs flash over (local Q, visiting KV) and the (O, lse)
    partials merge exactly. Causality on global block positions is a
    three-way split: the diagonal block (src == rank) runs the causal
    kernel, past blocks (src < rank) the unmasked one, and future blocks
    are skipped (zeros, lse -1e30) without a launch. GQA KV is read
    natively by the kernel."""
    n = mesh.n_dev

    def one_rotation(r, k_cur, v_cur, src):
        q = q_blks[r]
        if causal and src > r:
            sq, h, _ = q.shape
            return (torch.zeros(q.shape, dtype=torch.float32,
                                device=q.device),
                    torch.full((h, sq), _SKIP_LSE, dtype=torch.float32,
                               device=q.device))
        o, lse = flash_attention_lse(q, k_cur, v_cur,
                                     causal=causal and src == r)
        return o.float(), lse

    parts = [one_rotation(r, k_blks[r], v_blks[r], r) for r in range(n)]
    k_cur, v_cur = list(k_blks), list(v_blks)
    for step in range(1, n):
        k_cur, v_cur = _kv_rotate(k_cur, v_cur, mesh, use_dma_ring)
        for r in range(n):
            o2, lse2 = one_rotation(r, k_cur[r], v_cur[r], (r - step) % n)
            parts[r] = _merge_partials(*parts[r], o2, lse2)
    return [o.to(q.dtype) for (o, _), q in zip(parts, q_blks)]


def _fold_batch(blks: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """(b, s, h, d) blocks -> (s, b*h, d): the batch folded into the
    heads, batch-major (head ``bi*h + j``)."""
    return [x.permute(1, 0, 2, 3).reshape(x.shape[1], -1, x.shape[3])
            for x in blks]


def _unfold_batch(blks: Sequence[torch.Tensor], b: int) -> List[torch.Tensor]:
    """The inverse of :func:`_fold_batch` for a batch of ``b``."""
    return [x.reshape(x.shape[0], b, -1, x.shape[2]).permute(1, 0, 2, 3)
            .contiguous() for x in blks]


def batched(local_fn):
    """Lets a per-rank body take batched (b, S/n, h, d) blocks as well:
    they are folded into the heads for one run of the body and unfolded
    after it."""
    @functools.wraps(local_fn)
    def body(q_blks, k_blks, v_blks, mesh, **kw):
        q_blks = list(q_blks)
        if not q_blks or q_blks[0].dim() != 4:
            return local_fn(q_blks, k_blks, v_blks, mesh, **kw)
        out = local_fn(_fold_batch(q_blks), _fold_batch(k_blks),
                       _fold_batch(v_blks), mesh, **kw)
        return _unfold_batch(out, q_blks[0].shape[0])
    return body


def over_data_rows(local_fn, q, k, v, mesh: Mesh, **kw):
    """Runs a per-rank body over a ``("data", "seq")`` grid: (B, S, h,
    d) inputs cut into (B/d, S/s) blocks (``shard_grid``), each data
    row's blocks through ``local_fn`` on the row's ``seq`` sub-mesh, the
    output joined on ``mesh.device``. ``shard_map`` over the grid with a
    ``vmap`` of the body inside, as the JAX package composes it."""
    if mesh.names != (DATA_AXIS, SEQ_AXIS):
        raise ValueError(f"a 2-D attention mesh has axes "
                         f"{(DATA_AXIS, SEQ_AXIS)}, got {mesh.names}")
    if q.dim() != 4:
        raise ValueError(f"a {(DATA_AXIS, SEQ_AXIS)} mesh takes (batch, "
                         f"seq, heads, head_dim) inputs, got {q.dim()}-D")
    blocks = [shard_grid(x, mesh) for x in (q, k, v)]
    s = mesh.axis_size(SEQ_AXIS)
    out = []
    for i, row in enumerate(mesh.sub_meshes(SEQ_AXIS)):
        cut = slice(i * s, (i + 1) * s)
        out += local_fn(*(b[cut] for b in blocks), row, **kw)
    return unshard_grid(out, mesh)


@batched
def ring_attention_local(q_blks: Sequence[torch.Tensor],
                         k_blks: Sequence[torch.Tensor],
                         v_blks: Sequence[torch.Tensor], mesh: Mesh, *,
                         causal: bool = False, local: str = "xla",
                         use_dma_ring: Optional[bool] = None
                         ) -> List[torch.Tensor]:
    """The per-rank ring body, for composition: per-rank lists of
    (S/n, heads, head_dim) blocks in rank order (rank r holds sequence
    rows r*S/n onwards), or batched (b, S/n, heads, head_dim) blocks
    (see :func:`batched`), per-rank output blocks out.

    ``local`` picks the per-rank engine: ``"xla"`` (chunked online
    softmax in plain PyTorch, differentiable, recomputing each chunk's
    score slabs in backward so that training at S = 16384 fits on one
    card; ``"blockwise"`` is the same engine under Ulysses' name) or
    ``"flash"`` (the ``flash_fwd`` kernel, GQA KV read natively, and
    under grad its two backward kernels). KV rotates through the
    ``ring_exchange`` kernel (forward-only) unless a KV block needs a
    gradient, and then through plain copies;
    ``use_dma_ring=True`` or ``False`` forces the kernel or the copies."""
    q_blks, k_blks, v_blks = list(q_blks), list(k_blks), list(v_blks)
    n = mesh.n_dev
    if not len(q_blks) == len(k_blks) == len(v_blks) == n:
        raise ValueError(f"q, k, v need {n} per-rank blocks each")
    use_dma_ring = pick_ring(use_dma_ring, (k_blks, v_blks))
    if local == "flash":
        return _ring_flash_local(q_blks, k_blks, v_blks, mesh, causal,
                                 use_dma_ring)
    if local not in ("xla", "blockwise"):
        raise ValueError(f"unknown local attention engine {local!r}")
    sq, skv = q_blks[0].shape[0], k_blks[0].shape[0]
    q_pos = [r * sq + torch.arange(sq, device=q.device)
             for r, q in enumerate(q_blks)]

    def accumulate(r, k_cur, v_cur, src, state):
        return _accumulate_block(q_blks[r], q_pos[r], k_cur, v_cur,
                                 src * skv, *state, causal)

    # the local block first, then rotations 1 .. n-1: no final rotation
    # ships KV around the ring for nothing
    state = [accumulate(r, k_blks[r], v_blks[r], r, _acc_init(q_blks[r]))
             for r in range(n)]
    k_cur, v_cur = k_blks, v_blks
    for step in range(1, n):
        k_cur, v_cur = _kv_rotate(k_cur, v_cur, mesh, use_dma_ring)
        state = [accumulate(r, k_cur[r], v_cur[r], (r - step) % n, state[r])
                 for r in range(n)]
    return [_acc_finalize(o, l, q.dtype)
            for (_, l, o), q in zip(state, q_blks)]


def ring_attention(q, k, v, mesh: Optional[Mesh] = None,
                   causal: bool = False, local: str = "xla",
                   use_dma_ring: Optional[bool] = None):
    """Exact attention with the sequence sharded over the mesh axis.

    q (S, heads, head_dim), k and v (S, kv_heads, head_dim) (kv_heads <
    heads only with ``local="flash"``); S must divide by the number of
    ranks. The inputs are cut into contiguous per-rank blocks
    (``parallel.mesh.shard``), the ring runs, and the output (S, heads,
    head_dim) is gathered on ``mesh.device``. ``mesh`` defaults to one
    rank on q's device. On a ``("data", "seq")`` grid the inputs are
    (B, S, heads, head_dim), B sharded on ``data`` and S on ``seq``
    (:func:`over_data_rows`). See :func:`ring_attention_local` for
    ``local`` and ``use_dma_ring``."""
    mesh = mesh or make_mesh(q.device)
    kw = dict(causal=causal, local=local, use_dma_ring=use_dma_ring)
    if len(mesh.shape) > 1:
        return over_data_rows(ring_attention_local, q, k, v, mesh, **kw)
    blocks = [shard(x, mesh) for x in (q, k, v)]
    return unshard(ring_attention_local(*blocks, mesh, **kw), mesh)


def reference_attention(q, k, v, causal: bool = False):
    """Naive exact attention in q's dtype: q, k, v (S, heads, head_dim)
    with equal head counts. Every row's softmax runs over the whole key
    axis; rows are taken in chunks only to bound memory."""
    s, h, d = q.shape
    scale = torch.sqrt(torch.tensor(d, dtype=q.dtype))
    kt = k.permute(1, 2, 0)                                  # (h, d, S)
    vh = v.permute(1, 0, 2)                                  # (h, S, d)
    out = torch.empty_like(q)
    rows = max(1, _CHUNK_ELEMS // (h * s))
    kv_pos = torch.arange(s, device=q.device)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        sc = torch.matmul(q[r0:r1].permute(1, 0, 2), kt) / scale
        if causal:
            q_pos = torch.arange(r0, r1, device=q.device)[:, None]
            sc = sc.masked_fill(~(q_pos >= kv_pos[None, :]),
                                torch.finfo(sc.dtype).min)
        p = torch.softmax(sc, dim=-1)
        out[r0:r1] = torch.matmul(p, vh).permute(1, 0, 2)
    return out
