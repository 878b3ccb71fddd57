"""Full-matrix reference attention, the oracle of the attention planes.

Counterpart of ``reference_attention`` in
``fiber_tpu/ops/ring_attention.py``. The ring and blockwise engines of
that module are multi-device work and are not ported yet.
"""

from __future__ import annotations

import torch

#: elements of one (heads, rows, S) score tile; query rows are processed
#: in chunks of at most this many scores, so S = 16384 fits on one card
_CHUNK_ELEMS = 1 << 26


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
