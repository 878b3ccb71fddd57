"""Flash attention, forward and backward: the CUDA kernels
``csrc/flash_fwd.cu`` and ``csrc/flash_bwd.cu`` and their plain PyTorch
versions.

Counterpart of ``fiber_tpu/ops/pallas_attention.py`` (``flash_attention``,
``flash_attention_lse``, the forward kernel ``_fwd_kernel`` and the
backward kernels ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``). Layouts
are the JAX package's: q ``(S, heads, head_dim)``, k and v
``(S, kv_heads, head_dim)`` with ``kv_heads`` dividing ``heads``
(grouped-query attention), O in q's dtype and lse ``(heads, S)`` f32.

A CUDA tensor goes through the kernels or raises; a CPU tensor goes
through the plain versions. :func:`flash_attention` and
:func:`flash_attention_lse` are differentiable through one
``torch.autograd.Function`` whose backward is the FlashAttention-2
recurrence of the JAX custom VJP: ``delta = rowsum(dO * O) - dlse`` in
PyTorch, then the dq kernel and the dk/dv kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from fiber_tpu_torch import _build

_NEG_INF = -1e30  # large negative instead of -inf: no inf - inf NaNs
#: elements of one (heads, rows, S) f32 score tile in the plain version;
#: query rows are processed in chunks of at most this many scores
_CHUNK_ELEMS = 1 << 26
_MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v, causal, window):
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("q, k and v must be (S, heads, head_dim)")
    s, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != s or k.shape[2] != d:
        raise ValueError(
            f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
            f"(S={s}, kv_heads, head_dim={d})")
    kvh = k.shape[1]
    if kvh < 1 or h % kvh:
        raise ValueError(f"kv_heads {kvh} must be >= 1 and divide heads {h}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"q, k, v must share one dtype of {_DTYPES}; got "
            f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")
    if window is not None:
        if not causal:
            raise ValueError("window requires causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")


def _check_cuda(**tensors):
    """What the CUDA kernels take beyond :func:`_check`: CUDA tensors,
    head_dim up to 128 and unit stride along head_dim (other strides are
    free)."""
    if tensors["q"].device.type != "cuda":
        raise ValueError(f"unsupported device {tensors['q'].device}")
    d = tensors["q"].shape[2]
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM}")
    for name, x in tensors.items():
        if x.device != tensors["q"].device:
            raise ValueError(f"{name} is on {x.device}, q on "
                             f"{tensors['q'].device}")
        if x.stride(2) != 1:
            raise ValueError(f"{name} needs unit stride along head_dim")


def _keep_mask(r0, r1, s, causal, window, device):
    """(rows r0..r1, S) causal(+window) keep mask, None when not causal."""
    if not causal:
        return None
    q_pos = torch.arange(r0, r1, device=device)[:, None]
    kv_pos = torch.arange(s, device=device)[None, :]
    keep = q_pos >= kv_pos
    if window is not None:
        keep = keep & (q_pos - kv_pos < window)
    return keep


def flash_attention_reference(q, k, v, *, causal: bool = False,
                              window: Optional[int] = None):
    """Plain PyTorch version of the kernel, same semantics: f32 scores
    and statistics, -1e30 for masked scores, a fully masked row takes
    l = 0 -> 1, GQA by head grouping. Processes query rows in chunks so
    no (heads, S, S) score tensor is ever held. Returns (O, lse)."""
    _check(q, k, v, causal, window)
    s, h, d = q.shape
    group = h // k.shape[1]
    scale = 1.0 / (d ** 0.5)
    kt = k.float().repeat_interleave(group, dim=1).permute(1, 2, 0)
    vh = v.float().repeat_interleave(group, dim=1).permute(1, 0, 2)
    out = torch.empty(s, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(h, s, dtype=torch.float32, device=q.device)
    rows = max(1, _CHUNK_ELEMS // (h * s))
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        sc = torch.matmul(q[r0:r1].float().permute(1, 0, 2), kt) * scale
        keep = _keep_mask(r0, r1, s, causal, window, q.device)
        if keep is not None:
            sc = sc.masked_fill(~keep, _NEG_INF)
        m = sc.amax(dim=-1, keepdim=True)
        p = torch.exp(sc - m)
        if keep is not None:
            p = p.masked_fill(~keep, 0.0)
        l = p.sum(dim=-1, keepdim=True)
        safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
        out[r0:r1] = (torch.matmul(p, vh) / safe_l).permute(1, 0, 2).to(
            q.dtype)
        lse[:, r0:r1] = (m + torch.log(safe_l))[..., 0]
    return out, lse


def _declare(lib, name, args):
    fn = getattr(lib, name)
    fn.argtypes = args
    fn.restype = ctypes.c_int
    err = getattr(lib, f"{name}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p


@functools.cache
def _fwd_lib():
    lib = _build.load("flash_fwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _declare(lib, "flash_fwd", [p, p, p, p, p, i, i, i, i,
                                ll, ll, ll, ll, ll, ll,
                                i, i, ctypes.c_float, i, p])
    return lib


@functools.cache
def _bwd_lib():
    lib = _build.load("flash_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    # q, k, v, dO, lse, delta, outputs..., S, H, KVH, D, strides,
    # causal, window, scale, dtype, stream
    _declare(lib, "flash_bwd_dq", [p] * 7 + [i] * 4 + [p, i, i,
                                                       ctypes.c_float, i, p])
    _declare(lib, "flash_bwd_dkv", [p] * 8 + [i] * 4 + [p, i, i,
                                                        ctypes.c_float, i, p])
    return lib


def flash_fwd(q, k, v, *, causal: bool = False,
              window: Optional[int] = None):
    """The forward kernel's wrapper: (O, lse). On CUDA tensors it
    launches ``flash_fwd`` from ``csrc/flash_fwd.cu`` and counts the
    launch in ``flash_fwd.launches``; on CPU tensors it runs the plain
    version. Not differentiable: :func:`flash_attention` is."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    _check_cuda(q=q, k=k, v=v)
    s, h, d = q.shape
    out = torch.empty(s, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(h, s, dtype=torch.float32, device=q.device)
    lib = _fwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), s, h, k.shape[1], d,
            q.stride(0), q.stride(1), k.stride(0), k.stride(1),
            v.stride(0), v.stride(1), int(causal), int(window or 0),
            1.0 / (d ** 0.5), _DTYPES.index(q.dtype), stream)
    if rc != 0:
        raise RuntimeError(
            "flash_fwd launch failed: "
            + lib.flash_fwd_error_string(rc).decode())
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


# ---------------------------------------------------------------------------
# Backward (FlashAttention-2 recurrence, as pallas_attention.py:135-144)
#
#   p_ij  = exp(s_ij * scale - lse_i)        (masked entries 0)
#   ds_ij = p_ij * (dO_i . v_j - delta_i),   delta_i = rowsum(dO_i * O_i)
#                                                      - dlse_i
#   dq_i  = scale * sum_j ds_ij k_j
#   dk_j  = scale * sum_i ds_ij q_i,   dv_j = sum_i p_ij dO_i
# ---------------------------------------------------------------------------


def flash_bwd_delta(out, dout, dlse=None):
    """``delta = rowsum(dO * O) - dlse`` as (heads, S) f32: the one
    reduction the JAX package runs outside its backward kernels. The lse
    cotangent is exactly a shift of delta (d lse_i / d s_ij = p_ij)."""
    delta = torch.einsum("shd,shd->hs", dout.float(), out.float())
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def _check_bwd(q, k, v, dout, lse, delta, causal, window):
    _check(q, k, v, causal, window)
    s, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"dout {tuple(dout.shape)} {dout.dtype} must be "
                         f"q's {tuple(q.shape)} {q.dtype}")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (h, s) or x.dtype != torch.float32:
            raise ValueError(f"{name} must be ({h}, {s}) float32, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")


def flash_bwd_reference(q, k, v, dout, lse, delta, *, causal: bool = False,
                        window: Optional[int] = None, dq: bool = True,
                        dkv: bool = True):
    """Plain PyTorch version of both backward kernels, from ``delta``:
    ``(dq, dk, dv)``, with None for a part not asked for. f32 arithmetic,
    outputs in the inputs' dtypes. Query rows go in chunks, so no
    (heads, S, S) tensor is ever held: dk and dv accumulate across
    chunks, per query head, and are summed over each GQA group of
    ``heads // kv_heads`` heads (head ``ih`` feeds KV head
    ``ih // group``) at the end."""
    _check_bwd(q, k, v, dout, lse, delta, causal, window)
    s, h, d = q.shape
    kvh = k.shape[1]
    group = h // kvh
    scale = 1.0 / (d ** 0.5)
    kh = k.float().repeat_interleave(group, dim=1).permute(1, 0, 2)
    vh = v.float().repeat_interleave(group, dim=1).permute(1, 0, 2)
    dq_out = (torch.empty(s, h, d, dtype=q.dtype, device=q.device)
              if dq else None)
    if dkv:
        dk_acc = torch.zeros(h, s, d, dtype=torch.float32, device=q.device)
        dv_acc = torch.zeros_like(dk_acc)
    rows = max(1, _CHUNK_ELEMS // (h * s))
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        qc = q[r0:r1].float().permute(1, 0, 2)          # (h, rows, d)
        doc = dout[r0:r1].float().permute(1, 0, 2)
        p = torch.exp(torch.matmul(qc, kh.transpose(1, 2)) * scale
                      - lse[:, r0:r1, None])
        keep = _keep_mask(r0, r1, s, causal, window, q.device)
        if keep is not None:
            p = p.masked_fill(~keep, 0.0)
        ds = p * (torch.matmul(doc, vh.transpose(1, 2))
                  - delta[:, r0:r1, None])
        if dq:
            dq_out[r0:r1] = (torch.matmul(ds, kh) * scale).permute(
                1, 0, 2).to(q.dtype)
        if dkv:
            dk_acc += torch.matmul(ds.transpose(1, 2), qc)
            dv_acc += torch.matmul(p.transpose(1, 2), doc)
    if not dkv:
        return dq_out, None, None

    def per_kv_head(acc, dtype):
        return acc.reshape(kvh, group, s, d).sum(1).permute(1, 0, 2).to(
            dtype)

    return (dq_out, per_kv_head(dk_acc * scale, k.dtype),
            per_kv_head(dv_acc, v.dtype))


def flash_attention_bwd_reference(q, k, v, out, lse, dout, dlse=None, *,
                                  causal: bool = False,
                                  window: Optional[int] = None):
    """Plain backward of :func:`flash_attention_lse`: ``(dq, dk, dv)``
    from the forward's (O, lse) and the cotangents of O and lse (dlse
    None means 0). The explicit FlashAttention-2 recurrence, not autograd
    through the plain forward."""
    return flash_bwd_reference(q, k, v, dout, lse,
                               flash_bwd_delta(out, dout, dlse),
                               causal=causal, window=window)


def _launch_bwd(name, outs, q, k, v, dout, lse, delta, causal, window):
    """Launches backward kernel ``name`` of ``csrc/flash_bwd.cu`` on q's
    device and current stream, writing ``outs``; raises with the CUDA
    error string when the launch fails."""
    _check_cuda(q=q, k=k, v=v, dout=dout)
    lse, delta = lse.contiguous(), delta.contiguous()
    s, h, d = q.shape
    strides = (ctypes.c_longlong * 8)(
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0),
        v.stride(1), dout.stride(0), dout.stride(1))
    ptrs = [x.data_ptr() for x in (q, k, v, dout, lse, delta, *outs)]
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, name)(*ptrs, s, h, k.shape[1], d, strides,
                                int(causal), int(window or 0),
                                1.0 / (d ** 0.5), _DTYPES.index(q.dtype),
                                stream)
    if rc != 0:
        err = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} launch failed: {err}")


def flash_bwd_dq(q, k, v, dout, lse, delta, *, causal: bool = False,
                 window: Optional[int] = None):
    """The dq kernel's wrapper: dq ``(S, heads, head_dim)`` in q's dtype.
    On CUDA tensors it launches ``flash_bwd_dq`` from
    ``csrc/flash_bwd.cu`` and counts the launch in
    ``flash_bwd_dq.launches``; on CPU tensors it runs the plain version."""
    _check_bwd(q, k, v, dout, lse, delta, causal, window)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, dout, lse, delta, causal=causal,
                                   window=window, dkv=False)[0]
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch_bwd("flash_bwd_dq", (dq,), q, k, v, dout, lse, delta, causal,
                window)
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, dout, lse, delta, *, causal: bool = False,
                  window: Optional[int] = None):
    """The dk/dv kernel's wrapper: (dk, dv), each ``(S, kv_heads,
    head_dim)`` in k's dtype, summed over every query head of a GQA
    group. On CUDA tensors it launches ``flash_bwd_dkv`` from
    ``csrc/flash_bwd.cu`` and counts the launch in
    ``flash_bwd_dkv.launches``; on CPU tensors it runs the plain
    version."""
    _check_bwd(q, k, v, dout, lse, delta, causal, window)
    if q.device.type == "cpu":
        return flash_bwd_reference(q, k, v, dout, lse, delta, causal=causal,
                                   window=window, dq=False)[1:]
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty_like(dk)
    _launch_bwd("flash_bwd_dkv", (dk, dv), q, k, v, dout, lse, delta,
                causal, window)
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


class _FlashAttention(torch.autograd.Function):
    """(q, k, v) -> (O, lse) through ``flash_fwd``; the backward runs
    ``flash_bwd_dq`` and ``flash_bwd_dkv`` from the saved (q, k, v, O,
    lse), like the JAX package's custom VJP (``_make_attn``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_fwd(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        # an unused output's cotangent arrives as None, not as zeros
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, dout, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        # a sum() loss hands over a zero-stride dO: give the kernels rows
        dout = torch.zeros_like(out) if dout is None else dout.contiguous()
        delta = flash_bwd_delta(out, dout, dlse)
        kw = dict(causal=ctx.causal, window=ctx.window)
        dq = flash_bwd_dq(q, k, v, dout, lse, delta, **kw)
        dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, **kw)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False, block_q: int = 512,
                    block_kv: int = 512, window: Optional[int] = None):
    """Exact attention: (S, heads, head_dim) in q's dtype, differentiable.
    ``kv_heads`` < ``heads`` is grouped-query attention; ``window``
    (requires ``causal``) keeps only the last ``window`` keys of every
    row, self included. ``block_q``/``block_kv`` are kept for the JAX
    package's call sites; the kernels pick their own tiles."""
    del block_q, block_kv
    return _FlashAttention.apply(q, k, v, causal, window)[0]


def flash_attention_lse(q, k, v, *, causal: bool = False,
                        block_q: int = 512, block_kv: int = 512,
                        window: Optional[int] = None):
    """Like :func:`flash_attention`, and also the per-row logsumexp
    ``(heads, S)`` f32 (with a window, the windowed logsumexp).
    Differentiable in both outputs: the lse cotangent enters the
    backward as ``delta - dlse``."""
    del block_q, block_kv
    return _FlashAttention.apply(q, k, v, causal, window)
