"""``device_map``: ``Pool.map`` lowered to the device.

Counterpart of ``_stack_items``, ``DeviceMapPlan`` and ``device_map`` in
``fiber_tpu/parallel/dmap.py``. Where the host pool ships pickled
chunks to worker processes, ``device_map`` stacks the items into one
batch, pads it to a multiple of the mesh's rank count by repeating the
last item, runs ``torch.func.vmap(fn)`` over the rank-major batch and
returns a host list of the first ``len(items)`` results in order. On the
port's single-controller mesh every rank sits on one device, so one
vmapped call covers every rank's rows, as one ``eval_fn`` call covers
every rank's members in ``EvolutionStrategy.step``.

``fn`` maps one item's tensors to a tensor or a pytree of tensors of
fixed shapes. Under ``torch.func.vmap`` it may not call ``.item()`` or
branch in Python on a tensor's value, and it may not write in place into
a tensor it did not get as an argument or make from one (``total +=
x`` into a fresh ``torch.zeros``, say); write such updates out of place.
Items whose leaves are float64 or int64 numpy arrays or Python numbers
become f32 and int32 tensors, as JAX makes them without x64; torch
tensors keep their dtype and device.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from fiber_tpu_torch.parallel.mesh import Mesh, mesh_for

# numpy dtypes that JAX without x64 narrows when it puts them on a device
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32,
           np.dtype(np.complex128): np.complex64}


def _stack_items(items: List[Any]):
    """Stacks a list of pytrees into one pytree of batched leaves:
    numpy arrays for host leaves, tensors (on their device) for tensor
    leaves."""
    first = items[0]
    if isinstance(first, (int, float, complex, np.generic)) or (
            isinstance(first, np.ndarray) and first.ndim == 0):
        return np.asarray(items)
    flat = [pytree.tree_flatten(item) for item in items]
    spec = flat[0][1]
    for leaves, other in flat[1:]:
        if other != spec:
            raise ValueError(f"items differ in structure: {other} is not "
                             f"{spec}")
    stacked = [torch.stack(leaves) if torch.is_tensor(leaves[0])
               else np.stack([np.asarray(x) for x in leaves])
               for leaves in zip(*(leaves for leaves, _ in flat))]
    return pytree.tree_unflatten(stacked, spec)


def _to_device(x, device):
    if torch.is_tensor(x):
        return x.to(device)
    a = np.asarray(x)
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(_NARROW.get(a.dtype, a.dtype)))).to(device)


def _to_host(x):
    return x.detach().cpu().numpy()


class DeviceMapPlan:
    """Reusable ``device_map``: the mesh and the vmapped function are
    resolved once, and every call only stacks, pads, moves and runs.

    ``star=True`` takes each item as a tuple of positional arguments.
    ``broadcast``/``broadcast_positions`` (star only) pass shared
    arguments once, unbatched (``in_dims=None``), at those positions of
    the call; the items come with those positions already stripped.
    ``donate`` is accepted for the JAX package's signature and does
    nothing: PyTorch has no buffer donation, and the stacked batch is a
    fresh tensor that the call frees when it returns.
    """

    def __init__(self, fn: Callable, mesh: Optional[Mesh] = None,
                 star: bool = False, donate: bool = False,
                 broadcast: tuple = (), broadcast_positions: tuple = (),
                 device=None) -> None:
        self.fn = fn
        self.mesh = mesh_for(device, mesh)
        self.star = star
        self.donate = donate
        self.broadcast_positions = tuple(
            sorted(int(p) for p in broadcast_positions))
        if len(broadcast) != len(self.broadcast_positions):
            raise ValueError(
                "broadcast and broadcast_positions must pair up "
                f"({len(broadcast)} args, "
                f"{len(self.broadcast_positions)} positions)")
        if broadcast and not star:
            raise ValueError("broadcast args require star=True")
        self.broadcast = tuple(
            pytree.tree_map(lambda a: _to_device(a, self.mesh.device), b)
            for b in broadcast)
        positions = self.broadcast_positions

        if star and positions:
            def per_item(packed, *shared):
                # the shared args back at their call positions, in
                # ascending order so that later positions stay right
                args = list(packed)
                for pos, arg in zip(positions, shared):
                    args.insert(pos, arg)
                return fn(*args)
        elif star:
            def per_item(packed):
                return fn(*packed)
        else:
            per_item = fn
        self._mapped = torch.func.vmap(
            per_item, in_dims=(0,) + (None,) * len(positions))

    def __call__(self, iterable: Iterable[Any]) -> List[Any]:
        if isinstance(iterable, (np.ndarray, torch.Tensor)) \
                and iterable.ndim >= 1:
            n = len(iterable)           # already batched along dim 0
            batched = iterable
        else:
            items = list(iterable)
            n = len(items)
            batched = _stack_items(items) if n else None
        if not n:
            return []
        dev = self.mesh.device
        batched = pytree.tree_map(lambda a: _to_device(a, dev), batched)
        pad = (-n) % self.mesh.n_dev
        if pad:
            batched = pytree.tree_map(
                lambda a: torch.cat([a, a[-1:].expand(pad, *a.shape[1:])]),
                batched)
        with torch.no_grad():
            out = self._mapped(batched, *self.broadcast)
        host = pytree.tree_map(_to_host, out)
        if isinstance(host, np.ndarray):
            return [host[i] for i in range(n)]
        return [pytree.tree_map(lambda a: a[i], host) for i in range(n)]


def device_map(fn: Callable, iterable: Iterable[Any],
               mesh: Optional[Mesh] = None, star: bool = False,
               broadcast: tuple = (), broadcast_positions: tuple = (),
               device=None) -> List[Any]:
    """Maps ``fn`` over items on the device mesh (``mesh``, or one rank
    on ``device``: CUDA unless the caller asks for the CPU), returning a
    list of host (numpy) results in order. Items are scalars, arrays or
    pytrees of arrays or tensors, all of one structure and shape; with
    ``star=True`` each is a tuple of positional arguments. The one-shot
    form of :class:`DeviceMapPlan`. An empty map returns ``[]`` before
    any device is resolved."""
    if not isinstance(iterable, (np.ndarray, torch.Tensor)):
        iterable = list(iterable)
    if len(iterable) == 0:
        return []
    return DeviceMapPlan(fn, mesh=mesh, star=star, broadcast=broadcast,
                         broadcast_positions=broadcast_positions,
                         device=device)(iterable)
