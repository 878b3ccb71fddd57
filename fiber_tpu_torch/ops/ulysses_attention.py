"""Ulysses sequence parallelism: two all-to-all swaps around exact local
attention.

Counterpart of ``fiber_tpu/ops/ulysses_attention.py``. The inputs
arrive sharded along the sequence; the first swap gives every rank the
whole sequence for ``heads / n`` heads, attention runs locally and
exactly, and the second swap restores the sequence sharding. Ring
attention (``ops/ring_attention.py``) is the other plane: it has no
head-count constraint and never holds whole-sequence scores.

On the single-controller mesh (``parallel/mesh.py``) a swap moves every
rank's block at once: through ``ring_all_to_all`` (n - 1 launches of
the ``ring_exchange`` kernel per swap) when no block needs a gradient,
else through ``ops/collectives.all_to_all`` (plain copies,
differentiable); ``use_dma_ring=True`` or ``False`` forces one. On a
``("data", "seq")`` grid mesh, as on the ring plane, each data row runs
the body on its ``seq`` sub-mesh over its batch folded into the heads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.ops.dma_ring import pick_ring, ring_all_to_all
from fiber_tpu_torch.ops.flash_attention import flash_attention
from fiber_tpu_torch.ops.ring_attention import (
    batched,
    blockwise_attention,
    over_data_rows,
    reference_attention,
)
from fiber_tpu_torch.parallel.mesh import Mesh, make_mesh, shard, unshard


def _a2a(xs, mesh: Mesh, split_axis: int, concat_axis: int,
         use_dma_ring: Optional[bool]):
    """The tiled all-to-all of both swaps: the ``ring_exchange`` ring or
    plain copies, as :func:`~fiber_tpu_torch.ops.dma_ring.pick_ring`
    chooses."""
    if pick_ring(use_dma_ring, [xs]):
        return ring_all_to_all(xs, mesh, split_axis=split_axis,
                               concat_axis=concat_axis)
    return collectives.all_to_all(xs, mesh, split_axis=split_axis,
                                  concat_axis=concat_axis)


@batched
def ulysses_attention_local(q_blks: Sequence[torch.Tensor],
                            k_blks: Sequence[torch.Tensor],
                            v_blks: Sequence[torch.Tensor], mesh: Mesh, *,
                            causal: bool = False, local: str = "reference",
                            use_dma_ring: Optional[bool] = None
                            ) -> List[torch.Tensor]:
    """The per-rank Ulysses body, for composition: per-rank lists of
    (S/n, heads, head_dim) blocks in, or batched (b, S/n, heads,
    head_dim) blocks (b*heads must then divide by n), per-rank output
    blocks out; heads must divide by n.

    ``local`` picks the attention over the gathered sequence:
    ``"reference"`` (whole-row softmax, query rows in chunks),
    ``"blockwise"`` (KV-chunked online softmax) or ``"flash"`` (the
    ``flash_fwd`` kernel)."""
    if local not in ("reference", "blockwise", "flash"):
        raise ValueError(f"unknown local attention {local!r}")
    # swap 1: scatter heads, gather the sequence -> (S, heads/n, head_dim)
    qh, kh, vh = (_a2a(x, mesh, 1, 0, use_dma_ring)
                  for x in (q_blks, k_blks, v_blks))
    if local == "flash":
        attend = flash_attention
    elif local == "blockwise":
        attend = blockwise_attention
    else:
        attend = reference_attention
    out = [attend(q, k, v, causal=causal) for q, k, v in zip(qh, kh, vh)]
    # swap 2: scatter the sequence, gather heads -> the input layout
    return _a2a(out, mesh, 0, 1, use_dma_ring)


def ulysses_attention(q, k, v, mesh: Optional[Mesh] = None,
                      causal: bool = False, local: str = "reference",
                      use_dma_ring: Optional[bool] = None):
    """Exact attention with the sequence sharded over the mesh axis.

    q, k, v (S, heads, head_dim); S and heads must both divide by the
    number of ranks. Returns (S, heads, head_dim) on ``mesh.device``;
    ``mesh`` defaults to one rank on q's device. On a ``("data",
    "seq")`` grid the inputs are (B, S, heads, head_dim), B sharded on
    ``data`` and S on ``seq``, and (B/d)*heads must divide by the
    ``seq`` axis. See :func:`ulysses_attention_local` for ``local``; the
    swaps run over the ``ring_exchange`` kernel (forward-only) unless a
    block needs a gradient, or as ``use_dma_ring=True`` or ``False``
    forces."""
    mesh = mesh or make_mesh(q.device)
    kw = dict(causal=causal, local=local, use_dma_ring=use_dma_ring)
    if len(mesh.shape) > 1:
        return over_data_rows(ulysses_attention_local, q, k, v, mesh, **kw)
    n = mesh.n_dev
    seq, heads = q.shape[0], q.shape[1]
    if seq % n:
        raise ValueError(
            f"seq {seq} must be divisible by the mesh axis size {n}")
    if heads % n:
        raise ValueError(
            f"ulysses needs heads % n_dev == 0 (got {heads} heads over "
            f"{n} devices); use ring_attention for odd head counts")
    blocks = [shard(x, mesh) for x in (q, k, v)]
    return unshard(ulysses_attention_local(*blocks, mesh, **kw), mesh)
