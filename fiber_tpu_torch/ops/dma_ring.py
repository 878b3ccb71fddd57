"""Ring exchange along the mesh axis: the CUDA kernel
``csrc/dma_ring.cu``, its plain PyTorch version, and the all-to-all
built from it.

Counterpart of ``fiber_tpu/ops/dma_ring.py``:

* :func:`ring_exchange` rotates each of k arrays one step along the
  axis: rank r's block lands on rank (r + 1) mod n, the semantics of
  ``lax.ppermute`` with ``[(i, (i + 1) % n)]``. The TPU kernel starts
  every remote copy before it waits on any; here one launch copies
  every (rank, array) pair.
* :func:`ring_all_to_all` has ``lax.all_to_all(tiled=True)``'s
  semantics, built from n - 1 such rotations, for the Ulysses swap.

On the single-controller mesh (``parallel/mesh.py``) the JAX function's
per-device list of k arrays becomes, for each array, its list of
per-rank blocks: ``arrays[j][r]`` is array j on rank r. CUDA tensors go
through the kernel or raise; CPU tensors go through the plain version.
Like the TPU kernel, both are forward-only: the outputs carry no
autograd history, so the wrapper raises when gradients would be needed.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence

import torch

from fiber_tpu_torch import _build
from fiber_tpu_torch.ops import collectives
from fiber_tpu_torch.parallel.mesh import Mesh


def _check(arrays, mesh: Mesh):
    """``arrays`` as a list of per-rank lists, validated."""
    arrays = [list(per_rank) for per_rank in arrays]
    for j, per_rank in enumerate(arrays):
        if len(per_rank) != mesh.n_dev:
            raise ValueError(f"array {j} has {len(per_rank)} blocks for "
                             f"{mesh.n_dev} ranks")
        first = per_rank[0]
        for r, x in enumerate(per_rank):
            if x.shape != first.shape or x.dtype != first.dtype:
                raise ValueError(
                    f"array {j}: rank {r}'s block {tuple(x.shape)} "
                    f"{x.dtype} differs from rank 0's {tuple(first.shape)} "
                    f"{first.dtype}")
            if x.device != mesh.devices[r]:
                raise ValueError(f"array {j}: rank {r}'s block is on "
                                 f"{x.device}, the rank on "
                                 f"{mesh.devices[r]}")
            if torch.is_grad_enabled() and x.requires_grad:
                raise RuntimeError(
                    "ring_exchange is forward-only (no gradient, as the "
                    "TPU kernel); use the default engine to differentiate")
    return arrays


def pick_ring(use_dma_ring: Optional[bool],
              arrays: Sequence[Sequence[torch.Tensor]]) -> bool:
    """The rotation engine of the attention planes: ``use_dma_ring`` when
    the caller sets it, else the ring of this module unless a block needs
    a gradient, which only the plain-copy engines carry."""
    if use_dma_ring is not None:
        return use_dma_ring
    return not (torch.is_grad_enabled()
                and any(x.requires_grad for per_rank in arrays
                        for x in per_rank))


def ring_exchange_reference(arrays: Sequence[Sequence[torch.Tensor]],
                            mesh: Mesh) -> List[List[torch.Tensor]]:
    """Plain version: each block is copied to the next rank's device by
    ``collectives.ppermute`` (fresh tensors; the inputs are never
    aliased)."""
    return [collectives.ppermute(per_rank, mesh)
            for per_rank in _check(arrays, mesh)]


@functools.cache
def _lib():
    lib = _build.load("dma_ring")
    p = ctypes.c_void_p
    lib.ring_exchange.argtypes = [p, p, p, ctypes.c_int, p]
    lib.ring_exchange.restype = ctypes.c_int
    lib.ring_exchange_max_pairs.argtypes = []
    lib.ring_exchange_max_pairs.restype = ctypes.c_int
    lib.ring_exchange_error_string.argtypes = [ctypes.c_int]
    lib.ring_exchange_error_string.restype = ctypes.c_char_p
    return lib


def ring_exchange(arrays: Sequence[Sequence[torch.Tensor]],
                  mesh: Mesh) -> List[List[torch.Tensor]]:
    """Rotate every array one step right along the mesh axis:
    ``out[j][(r + 1) % n]`` equals ``arrays[j][r]`` bit for bit, in a
    fresh tensor on rank (r + 1)'s device. At n <= 1, or with no arrays,
    the inputs come back unchanged and nothing launches.

    On CUDA blocks it launches ``ring_exchange`` from
    ``csrc/dma_ring.cu`` once for all (rank, array) pairs, on the current
    stream, and counts the launch in ``ring_exchange.launches``; blocks
    must be contiguous. On CPU blocks it runs the plain version."""
    if mesh.n_dev <= 1 or not arrays:
        return [list(per_rank) for per_rank in arrays]
    arrays = _check(arrays, mesh)
    dev = mesh.device
    if dev.type == "cpu":
        return ring_exchange_reference(arrays, mesh)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = mesh.n_dev
    outs = [[torch.empty_like(x, device=mesh.devices[(r + 1) % n])
             for r, x in enumerate(per_rank)] for per_rank in arrays]
    srcs, dsts, sizes = [], [], []
    for j, per_rank in enumerate(arrays):
        for r, x in enumerate(per_rank):
            if not x.is_contiguous():
                raise ValueError(f"array {j}: rank {r}'s block is not "
                                 "contiguous")
            srcs.append(x.data_ptr())
            dsts.append(outs[j][(r + 1) % n].data_ptr())
            sizes.append(x.nbytes)
    if not any(sizes):
        return outs
    lib = _lib()
    if len(srcs) > lib.ring_exchange_max_pairs():
        raise ValueError(
            f"{len(srcs)} (rank, array) pairs; the kernel takes at most "
            f"{lib.ring_exchange_max_pairs()} in one launch")
    count = len(srcs)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ring_exchange((ctypes.c_void_p * count)(*srcs),
                               (ctypes.c_void_p * count)(*dsts),
                               (ctypes.c_longlong * count)(*sizes), count,
                               stream)
    if rc != 0:
        raise RuntimeError("ring_exchange launch failed: "
                           + lib.ring_exchange_error_string(rc).decode())
    ring_exchange.launches += 1
    return outs


ring_exchange.launches = 0


def ring_all_to_all(xs: Sequence[torch.Tensor], mesh: Mesh, split_axis: int,
                    concat_axis: int) -> List[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``
    over the ring: the whole per-rank array rotates n - 1 steps through
    :func:`ring_exchange`; after each step every rank takes its own block
    of the visiting array along ``split_axis`` and lays it at the source
    rank's slot along ``concat_axis``. Moves (n - 1) times the array,
    where a native all-to-all moves it once: the JAX package's trade for
    overlapped copies. Raises unless n divides ``split_axis``."""
    xs = list(xs)
    n = mesh.n_dev
    if n <= 1:
        return xs
    if len(xs) != n:
        raise ValueError(f"{len(xs)} per-rank values for {n} ranks")
    if xs[0].shape[split_axis] % n:
        raise ValueError(
            f"split axis {split_axis} ({xs[0].shape[split_axis]}) must "
            f"divide by the ring size {n}")
    seg = xs[0].shape[split_axis] // n
    cat = xs[0].shape[concat_axis]
    out_shape = list(xs[0].shape)
    out_shape[split_axis] = seg
    out_shape[concat_axis] = cat * n
    # every slot is written exactly once, at the step its source visits
    outs = [torch.empty(out_shape, dtype=x.dtype, device=x.device)
            for x in xs]

    def place(cur, step):
        for my in range(n):
            src = (my - step) % n
            outs[my].narrow(concat_axis, src * cat, cat).copy_(
                cur[my].narrow(split_axis, my * seg, seg))

    cur = [x.contiguous() for x in xs]
    place(cur, 0)
    for step in range(1, n):
        (cur,) = ring_exchange([cur], mesh)
        place(cur, step)
    return outs
