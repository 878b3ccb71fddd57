"""The device mesh of the device plane: a ``pool`` axis of n ranks, or
a grid of named axes such as ``("data", "seq")``.

Counterpart of ``fiber_tpu/parallel/mesh.py``. The mesh is
single-controller, as JAX's ``shard_map`` is: one process drives every
rank, a per-rank body becomes a loop over ranks, and a sharded array is
a list of per-rank shards. Ranks may all sit on one device (the JAX
package's tests run 8 virtual CPU devices the same way). A mesh whose
ranks span several CUDA devices (peer copies over NVLink, event
ordering between the cards) is ROADMAP item A.7 and raises
``NotImplementedError`` for now.

:func:`shard` and :func:`unshard` stand in for ``shard_map``'s
``P(axis)`` in and out specs: dim 0 is cut into n contiguous blocks, one
per rank, in rank order. A grid mesh of shape ``(d, s)`` puts rank
``i * s + j`` at ``(i, j)`` (row-major, as JAX's device array);
:meth:`Mesh.sub_meshes` cuts it into the 1-D meshes along one axis
that the per-rank bodies take, and :func:`shard_grid` and
:func:`unshard_grid` stand in for ``P("data", "seq")``: tensor dim k
cut along the k-th mesh axis.

A process mesh (``make_mesh(device, group=torch.distributed.group.WORLD)``)
is the counterpart of JAX's ``Mesh(np.array(jax.devices()), ("pool",))``
after ``jax.distributed.initialize``, which spans every process: its
ranks are the processes of a ``torch.distributed`` group, and this
process holds rank ``dist.get_rank(group)`` on its own device (every
entry of ``devices``, ``device`` included, is this process's device).
Collectives on it cross processes (``ops/collectives.py``); the
single-controller functions below, which need every rank's block in
one process, are not for it.

:func:`default_mesh` is the process-wide default of the JAX package's
``default_mesh``: the grid that the ``mesh_shape`` setting names
(:func:`mesh_from_config`), else one rank on the device, since the
port's ranks are not the machine's devices. The JAX module's
``is_multidevice_cpu`` and ``cpu_step_barrier`` guard XLA's in-process
CPU collective rendezvous, which the port does not have: a
single-controller mesh runs its ranks one after another in one thread.
They have no counterpart here.
"""

from __future__ import annotations

import itertools
import math
import threading
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from fiber_tpu_torch.device import resolve_device

POOL_AXIS = "pool"
#: axis names of a grid given by shape alone, as the JAX package's
#: ``mesh_from_config`` names them
_DEFAULT_NAMES = (POOL_AXIS, "model", "data")


@dataclass(frozen=True)
class Mesh:
    """``devices[r]`` is rank r's device. A 1-D mesh has one axis, named
    ``axis``; a grid has ``shape`` and ``names`` (one name an axis;
    ``axis`` is then the first), with rank ``r`` at the row-major
    position of ``r`` in ``shape``."""

    devices: Tuple[torch.device, ...]
    axis: str = POOL_AXIS
    shape: Tuple[int, ...] = ()
    names: Tuple[str, ...] = ()
    #: the ``torch.distributed`` group of a process mesh, None on a
    #: single-controller one
    group: Optional[object] = None
    #: this process's rank on a process mesh (0 on a single-controller
    #: one, which holds every rank)
    rank: int = 0

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one rank")
        shape = tuple(self.shape) or (len(self.devices),)
        names = tuple(self.names) or (self.axis,)
        if len(names) != len(shape) or len(set(names)) != len(names):
            raise ValueError(f"mesh axes {names} do not name the {shape} "
                             "grid's axes once each")
        if math.prod(shape) != len(self.devices):
            raise ValueError(f"a {shape} mesh needs {math.prod(shape)} "
                             f"ranks, got {len(self.devices)}")
        object.__setattr__(self, "shape", shape)
        object.__setattr__(self, "names", names)
        object.__setattr__(self, "axis", names[0])
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(
                f"a mesh's ranks must share one device type, got "
                f"{sorted({str(d) for d in self.devices})}")
        if self.group is not None and len(shape) > 1:
            raise NotImplementedError("a process mesh has one axis")
        if len(set(self.devices)) > 1:
            raise NotImplementedError(
                "ranks on several CUDA devices are ROADMAP item A.7; put "
                "every rank on one device for now")

    @property
    def n_dev(self) -> int:
        """Number of ranks (on every axis together)."""
        return len(self.devices)

    def axis_size(self, name: str) -> int:
        """The number of ranks along axis ``name``."""
        return self.shape[self._axis_index(name)]

    def _axis_index(self, name: str) -> int:
        if name not in self.names:
            raise ValueError(f"no mesh axis {name!r} in {self.names}")
        return self.names.index(name)

    def sub_meshes(self, name: str) -> List["Mesh"]:
        """The 1-D meshes along axis ``name``, one for each position on
        the other axes, in row-major order of those positions: on a
        ``(d, s)`` grid, ``sub_meshes(names[1])[i]`` holds ranks ``i * s``
        to ``i * s + s - 1`` (row i)."""
        if self.group is not None:
            raise NotImplementedError("a process mesh has no sub-meshes")
        k = self._axis_index(name)
        grid = torch.arange(self.n_dev).reshape(self.shape).movedim(k, -1)
        return [Mesh(tuple(self.devices[r] for r in row.tolist()), name)
                for row in grid.reshape(-1, self.shape[k])]

    @property
    def device(self) -> torch.device:
        """Rank 0's device, where replicated values and gathered arrays
        live; on a process mesh, this process's device."""
        return self.devices[0]


def make_mesh(device=None, n: int = 1,
              shape: Optional[Sequence[int]] = None,
              names: Optional[Sequence[str]] = None,
              group=None) -> Mesh:
    """A mesh with every rank on ``device`` (CUDA unless the caller asks
    for the CPU): an ``n``-rank ``pool`` axis, or with ``shape`` a grid
    of that shape whose axes ``names`` names (by default the JAX
    package's ``("pool", "model", "data")``, as many as the grid has
    axes). With ``group`` (an initialized ``torch.distributed`` group,
    such as ``torch.distributed.group.WORLD``), the process mesh of that
    group's processes, this one's rank on ``device``."""
    if group is not None:
        import torch.distributed as dist

        if shape is not None or n != 1:
            raise ValueError("a process mesh has one rank a process of "
                             "its group; give no n or shape")
        return Mesh((resolve_device(device),) * dist.get_world_size(group),
                    group=group, rank=dist.get_rank(group))
    if shape is None:
        if n < 1:
            raise ValueError(f"a mesh needs n >= 1 ranks, got {n}")
        shape = (n,)
    shape = tuple(int(d) for d in shape)
    if not shape or min(shape) < 1:
        raise ValueError(f"a mesh shape needs axes of >= 1 ranks, got "
                         f"{shape}")
    names = tuple(names) if names else _DEFAULT_NAMES[:len(shape)]
    return Mesh((resolve_device(device),) * math.prod(shape),
                shape=shape, names=names)


def mesh_shape(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, names)`` of a mesh spec such as ``"4x2"``, as the JAX
    package's ``mesh_from_config`` parses its ``mesh_shape`` setting:
    ``((4, 2), ("pool", "model"))``."""
    dims = tuple(int(d) for d in spec.lower().split("x"))
    if len(dims) > len(_DEFAULT_NAMES):
        raise ValueError(f"mesh spec {spec!r} has more than "
                         f"{len(_DEFAULT_NAMES)} axes")
    return dims, _DEFAULT_NAMES[:len(dims)]


def mesh_from_config() -> Optional[Tuple[Tuple[int, ...], Tuple[str, ...]]]:
    """``(shape, names)`` of the ``mesh_shape`` setting (see
    :func:`mesh_shape`), or None when it is empty."""
    from fiber_tpu_torch import config

    spec = config.get().mesh_shape
    return mesh_shape(spec) if spec else None


_default_meshes: dict = {}
_default_lock = threading.Lock()


def default_mesh(device=None) -> Mesh:
    """The process-wide default mesh on ``device`` (CUDA unless the
    caller asks for the CPU), made at the first call for that device:
    the grid that :func:`mesh_from_config` names, every rank on the
    device, else one rank."""
    dev = resolve_device(device)
    with _default_lock:
        mesh = _default_meshes.get(dev)
        if mesh is None:
            cfg = mesh_from_config()
            mesh = (make_mesh(dev) if cfg is None
                    else make_mesh(dev, shape=cfg[0], names=cfg[1]))
            _default_meshes[dev] = mesh
        return mesh


def reset_default_mesh() -> None:
    """Drops the default meshes, so that the next :func:`default_mesh`
    reads the ``mesh_shape`` setting again."""
    with _default_lock:
        _default_meshes.clear()


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


def _grid_cuts(x: torch.Tensor, mesh: Mesh) -> Tuple[int, ...]:
    """Each of ``x``'s first ``len(mesh.shape)`` dims' block length,
    checking that every mesh axis divides its dim."""
    if x.dim() < len(mesh.shape):
        raise ValueError(f"a {x.dim()}-D tensor on a {mesh.shape} grid")
    for dim, (size, n) in enumerate(zip(x.shape, mesh.shape)):
        if size % n:
            raise ValueError(f"dim {dim} ({size}) must be divisible by "
                             f"the mesh axis {mesh.names[dim]!r} ({n})")
    return tuple(size // n for size, n in zip(x.shape, mesh.shape))


def shard_grid(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """Cuts ``x``'s dim k into ``mesh.shape[k]`` contiguous blocks for
    every mesh axis k (``P(*mesh.names)``): rank r gets the block at its
    grid position, on ``mesh.devices[r]``, contiguous."""
    cuts = _grid_cuts(x, mesh)
    positions = itertools.product(*(range(n) for n in mesh.shape))
    return [x[tuple(slice(p * c, (p + 1) * c) for p, c in zip(pos, cuts))]
            .to(dev).contiguous()
            for pos, dev in zip(positions, mesh.devices)]


def unshard_grid(blocks: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The inverse of :func:`shard_grid`, on ``mesh.device``."""
    if len(blocks) != mesh.n_dev:
        raise ValueError(f"{len(blocks)} blocks for {mesh.n_dev} ranks")
    rows = [b.to(mesh.device) for b in blocks]
    for k in reversed(range(len(mesh.shape))):
        n = mesh.shape[k]
        rows = [torch.cat(rows[i:i + n], dim=k)
                for i in range(0, len(rows), n)]
    return rows[0]
