"""On-device collectives over a :class:`~fiber_tpu_torch.parallel.mesh.Mesh`.

Counterpart of the on-device half of ``fiber_tpu/ops/collectives.py``
(``psum_sharded``, ``pmean_sharded``, ``all_gather_sharded``,
``broadcast_to_mesh``), plus the per-rank primitives that stand in for
``lax.psum``, ``lax.pmean``, ``lax.all_gather``, ``lax.ppermute`` and
``lax.all_to_all(tiled=True)`` inside a per-rank body. The host-plane
``HostRing`` is not part of the port.

The mesh is single-controller (see ``parallel/mesh.py``): a per-rank
value is a list with one tensor per rank, and a replicated result is
one tensor on ``mesh.device``. Every function here is a plain tensor
copy or sum; :func:`ppermute` and :func:`all_to_all` are the
differentiable engines of the sequence-parallel planes, and
``ops/dma_ring.py`` holds the kernel that replaces them when no gradient
is needed. Sums run in rank order.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from fiber_tpu_torch.parallel.mesh import Mesh


def _per_rank(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    xs = list(xs)
    if len(xs) != mesh.n_dev:
        raise ValueError(f"{len(xs)} per-rank values for {mesh.n_dev} "
                         "ranks")
    return xs


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """``lax.psum``: the sum of the per-rank values."""
    xs = _per_rank(xs, mesh)
    total = xs[0].to(mesh.device)
    for x in xs[1:]:
        total = total + x.to(mesh.device)
    return total


def pmean(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """``lax.pmean``: the mean of the per-rank values."""
    return psum(xs, mesh) / mesh.n_dev


def all_gather(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """``lax.all_gather``: the per-rank values stacked rank-major,
    ``(n, *x.shape)``."""
    return torch.stack([x.to(mesh.device) for x in _per_rank(xs, mesh)])


def ppermute(xs: Sequence[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    """``lax.ppermute`` with ``[(i, (i + 1) % n)]``: rank i's value is
    copied to rank (i + 1) mod n. The outputs are fresh tensors."""
    xs = _per_rank(xs, mesh)
    n = mesh.n_dev
    return [xs[(r - 1) % n].to(mesh.devices[r], copy=True)
            for r in range(n)]


def all_to_all(xs: Sequence[torch.Tensor], mesh: Mesh, split_axis: int,
               concat_axis: int) -> List[torch.Tensor]:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    every rank cuts its value into n blocks along ``split_axis``; rank r
    receives block r of every rank, concatenated in rank order along
    ``concat_axis``."""
    xs = _per_rank(xs, mesh)
    n = mesh.n_dev
    if xs[0].shape[split_axis] % n:
        raise ValueError(
            f"split axis {split_axis} ({xs[0].shape[split_axis]}) must "
            f"divide by the mesh axis size {n}")
    blocks = [torch.chunk(x, n, dim=split_axis) for x in xs]
    return [torch.cat([blocks[src][r].to(mesh.devices[r])
                       for src in range(n)], dim=concat_axis)
            for r in range(n)]


def psum_sharded(shards: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Sum an array sharded over the mesh along dim 0 (its per-rank
    shards): every rank sums its rows, then the partial sums are summed
    across ranks."""
    return psum([s.sum(dim=0) for s in _per_rank(shards, mesh)], mesh)


def pmean_sharded(shards: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """:func:`psum_sharded` over the number of rows of the whole array."""
    return psum_sharded(shards, mesh) / sum(s.shape[0] for s in shards)


def all_gather_sharded(shards: Sequence[torch.Tensor],
                       mesh: Mesh) -> torch.Tensor:
    """The whole of a sharded array, on ``mesh.device``."""
    return torch.cat([s.to(mesh.device) for s in _per_rank(shards, mesh)])


def broadcast_to_mesh(x, mesh: Mesh) -> List[torch.Tensor]:
    """Replicate ``x`` (a tensor or array-like) onto every rank: one
    crossing to rank 0's device, then a copy per further rank."""
    first = torch.as_tensor(x).to(mesh.device, copy=True)
    return [first] + [first.to(dev, copy=True) for dev in mesh.devices[1:]]
