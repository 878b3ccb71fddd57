"""Flash attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and
its plain PyTorch version.

Counterpart of ``fiber_tpu/ops/pallas_attention.py`` (``flash_attention``,
``flash_attention_lse`` and the forward kernel ``_fwd_kernel``). Layouts
are the JAX package's: q ``(S, heads, head_dim)``, k and v
``(S, kv_heads, head_dim)`` with ``kv_heads`` dividing ``heads``
(grouped-query attention), O in q's dtype and lse ``(heads, S)`` f32.

A CUDA tensor goes through the kernel or raises; a CPU tensor goes
through :func:`flash_attention_reference`. The backward kernels are not
ported yet, so a CUDA input that requires grad raises.
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
    kv_pos = torch.arange(s, device=q.device)
    for r0 in range(0, s, rows):
        r1 = min(s, r0 + rows)
        sc = torch.matmul(q[r0:r1].float().permute(1, 0, 2), kt) * scale
        keep = None
        if causal:
            q_pos = torch.arange(r0, r1, device=q.device)[:, None]
            keep = q_pos >= kv_pos[None, :]
            if window is not None:
                keep = keep & (q_pos - kv_pos[None, :] < window)
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


@functools.cache
def _kernel_lib():
    lib = _build.load("flash_fwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i,
                              ll, ll, ll, ll, ll, ll,
                              i, i, ctypes.c_float, i, p]
    lib.flash_fwd.restype = ctypes.c_int
    lib.flash_fwd_error_string.argtypes = [i]
    lib.flash_fwd_error_string.restype = ctypes.c_char_p
    return lib


def flash_fwd(q, k, v, *, causal: bool = False,
              window: Optional[int] = None):
    """The kernel's wrapper: (O, lse). On CUDA tensors it launches
    ``flash_fwd`` from ``csrc/flash_fwd.cu`` and counts the launch in
    ``flash_fwd.launches``; on CPU tensors it runs the plain version."""
    _check(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         window=window)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if torch.is_grad_enabled() and (
            q.requires_grad or k.requires_grad or v.requires_grad):
        raise NotImplementedError(
            "flash attention backward on CUDA (the dq and dk/dv kernels) "
            "is the next slice of the port; run the forward under "
            "torch.no_grad()")
    s, h, d = q.shape
    if d > _MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {_MAX_HEAD_DIM}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.stride(2) != 1:
            raise ValueError(f"{name} needs unit stride along head_dim")
    out = torch.empty(s, h, d, dtype=q.dtype, device=q.device)
    lse = torch.empty(h, s, dtype=torch.float32, device=q.device)
    lib = _kernel_lib()
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


def flash_attention(q, k, v, *, causal: bool = False, block_q: int = 512,
                    block_kv: int = 512, window: Optional[int] = None):
    """Exact attention: (S, heads, head_dim) in q's dtype. ``kv_heads``
    < ``heads`` is grouped-query attention; ``window`` (requires
    ``causal``) keeps only the last ``window`` keys of every row, self
    included. ``block_q``/``block_kv`` are kept for the JAX package's
    call sites; the kernel picks its own tiles."""
    del block_q, block_kv
    return flash_fwd(q, k, v, causal=causal, window=window)[0]


def flash_attention_lse(q, k, v, *, causal: bool = False,
                        block_q: int = 512, block_kv: int = 512,
                        window: Optional[int] = None):
    """Like :func:`flash_attention`, and also the per-row logsumexp
    ``(heads, S)`` f32 (with a window, the windowed logsumexp)."""
    del block_q, block_kv
    return flash_fwd(q, k, v, causal=causal, window=window)
