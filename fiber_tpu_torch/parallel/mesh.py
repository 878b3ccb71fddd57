"""The device mesh of the device plane: one ``pool`` axis of n ranks.

Counterpart of ``fiber_tpu/parallel/mesh.py``. The mesh is
single-controller, as JAX's ``shard_map`` is: one process drives every
rank, a per-rank body becomes a loop over ranks, and a sharded array is
a list of per-rank shards. Ranks may all sit on one device (the JAX
package's tests run 8 virtual CPU devices the same way). A mesh whose
ranks span several CUDA devices (peer copies over NVLink, event
ordering between the cards) is ROADMAP item A.8 and raises
``NotImplementedError`` for now.

:func:`shard` and :func:`unshard` stand in for ``shard_map``'s
``P(axis)`` in and out specs: dim 0 is cut into n contiguous blocks, one
per rank, in rank order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from fiber_tpu_torch.device import resolve_device

POOL_AXIS = "pool"


@dataclass(frozen=True)
class Mesh:
    """``devices[r]`` is rank r's device; ``axis`` names the mesh axis."""

    devices: Tuple[torch.device, ...]
    axis: str = POOL_AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(
                f"a mesh's ranks must share one device type, got "
                f"{sorted({str(d) for d in self.devices})}")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                "ranks on several CUDA devices are ROADMAP item A.8; put "
                "every rank on one device for now")

    @property
    def n_dev(self) -> int:
        """Number of ranks on the axis."""
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """Rank 0's device, where replicated values and gathered arrays
        live."""
        return self.devices[0]


def make_mesh(device=None, n: int = 1) -> Mesh:
    """An ``n``-rank ``pool`` axis with every rank on ``device`` (CUDA
    unless the caller asks for the CPU)."""
    if n < 1:
        raise ValueError(f"a mesh needs n >= 1 ranks, got {n}")
    return Mesh((resolve_device(device),) * n)


def mesh_for(device=None, mesh: Mesh = None) -> Mesh:
    """The mesh an entry point runs on: ``mesh``, or one rank on
    ``device`` (CUDA unless the caller asks for the CPU) when none is
    given. Raises when both are given and name different devices."""
    if mesh is None:
        return make_mesh(device)
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's device "
                         f"{mesh.device}")
    return mesh


def shard(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Split ``x`` along dim 0 into ``mesh.n_dev`` contiguous blocks, rank
    r's on ``mesh.devices[r]``. Blocks that are not contiguous (slices of
    a strided view) are copied. Raises unless n divides dim 0."""
    n = mesh.n_dev
    if x.shape[0] % n:
        raise ValueError(f"dim 0 ({x.shape[0]}) must be divisible by the "
                         f"mesh axis size {n}")
    return [blk.to(dev).contiguous()
            for blk, dev in zip(torch.chunk(x, n), mesh.devices)]


def unshard(shards: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """Concatenate per-rank blocks along dim 0 on ``mesh.device``."""
    if len(shards) != mesh.n_dev:
        raise ValueError(f"{len(shards)} shards for {mesh.n_dev} ranks")
    return torch.cat([s.to(mesh.device) for s in shards])
