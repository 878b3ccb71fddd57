"""Collectives: on-device ones over a
:class:`~fiber_tpu_torch.parallel.mesh.Mesh`, and a host-plane ring
allreduce over framed TCP for state that lives in separate processes.

Counterpart of ``fiber_tpu/ops/collectives.py``: the on-device half
(``psum_sharded``, ``pmean_sharded``, ``all_gather_sharded``,
``broadcast_to_mesh``), plus the per-rank primitives that stand in for
``lax.psum``, ``lax.pmean``, ``lax.all_gather``, ``lax.ppermute`` and
``lax.all_to_all(tiled=True)`` inside a per-rank body, and
:class:`HostRing`, the two-phase ring allreduce of a ``Ring``'s ranks.

On a single-controller mesh (see ``parallel/mesh.py``) a per-rank value
is a list with one tensor per rank, and a replicated result is one
tensor on ``mesh.device``. Every function here is then a plain tensor
copy or sum; :func:`ppermute` and :func:`all_to_all` are the
differentiable engines of the sequence-parallel planes, and
``ops/dma_ring.py`` holds the kernel that replaces them when no gradient
is needed. Sums run in rank order.

On a process mesh (``make_mesh(group=)``), whose ranks are the
processes of a ``torch.distributed`` group, each process holds one rank:
a per-rank value is this process's one tensor (or a one-element
sequence of it), and :func:`psum`, :func:`pmean` and :func:`all_gather`
run ``dist.all_reduce`` and ``dist.all_gather`` over the group. gloo
takes the card's tensors as they are for both; the order in which it
sums across more than two ranks is its own. The other per-rank
functions need every rank's value in this process and raise there.

Importing this module imports no torch, so that a ``Ring`` rank whose
work needs only numpy reaches :class:`HostRing` without it.
"""

from __future__ import annotations

import socket as pysocket
import sys
import threading
import time
from typing import TYPE_CHECKING, List, Optional, Sequence, Tuple

from fiber_tpu_torch.framing import recv_frame, send_frame

if TYPE_CHECKING:
    import torch

    from fiber_tpu_torch.parallel.mesh import Mesh


def _per_rank(xs: Sequence[torch.Tensor], mesh: Mesh) -> list:
    if mesh.group is not None:
        raise NotImplementedError(
            "on a process mesh each process holds one rank's value; only "
            "psum, pmean and all_gather reach the others")
    xs = list(xs)
    if len(xs) != mesh.n_dev:
        raise ValueError(f"{len(xs)} per-rank values for {mesh.n_dev} "
                         "ranks")
    return xs


def _own_value(x, mesh: Mesh) -> torch.Tensor:
    """This process's per-rank value on a process mesh: the tensor, or
    the one tensor of a sequence."""
    import torch

    if not isinstance(x, torch.Tensor):
        x = list(x)
        if len(x) != 1:
            raise ValueError(f"{len(x)} per-rank values in one process of "
                             "a process mesh")
        x = x[0]
    return x.to(mesh.device)


def psum(xs: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """``lax.psum``: the sum of the per-rank values."""
    if mesh.group is not None:
        import torch.distributed as dist

        total = _own_value(xs, mesh).clone()
        dist.all_reduce(total, group=mesh.group)
        return total
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
    import torch

    if mesh.group is not None:
        import torch.distributed as dist

        own = _own_value(xs, mesh).contiguous()
        parts = [torch.empty_like(own) for _ in range(mesh.n_dev)]
        dist.all_gather(parts, own, group=mesh.group)
        return torch.stack(parts)
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
    import torch

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
    import torch

    return torch.cat([s.to(mesh.device) for s in _per_rank(shards, mesh)])


def broadcast_to_mesh(x, mesh: Mesh) -> List[torch.Tensor]:
    """Replicate ``x`` (a tensor or array-like) onto every rank: one
    crossing to rank 0's device, then a copy per further rank."""
    import torch

    first = torch.as_tensor(x).to(mesh.device, copy=True)
    return [first] + [first.to(dev, copy=True) for dev in mesh.devices[1:]]


# ---------------------------------------------------------------------------
# Host-plane ring collectives (TCP)
# ---------------------------------------------------------------------------


def _to_host(array):
    """``(numpy copy of array, the tensor's device or None)``. A tensor
    crosses to the host here, once; anything else is taken as numpy
    takes it."""
    import numpy as np

    torch = sys.modules.get("torch")
    if torch is not None and isinstance(array, torch.Tensor):
        return array.detach().to("cpu", copy=True).numpy(), array.device
    return np.array(array, copy=True), None


def _from_host(out, device):
    """The result as the caller gave its input: numpy, or a tensor on the
    input tensor's device."""
    if device is None:
        return out
    import torch

    return torch.from_numpy(out).to(device)


class HostRing:
    """A ring of processes doing chunked allreduce over framed TCP.

    Build one per rank after rendezvous (every rank knows every
    ``(ip, port)``). Wire-up: every rank listens at its own address,
    dials its successor, and accepts its predecessor.

    Arrays are reduced on the host, in numpy, with the JAX package's
    chunking and hop order, so that the sums are equal to its bit for
    bit. A numpy array (or anything numpy takes) in gives numpy out; a
    torch tensor in gives a tensor out, on the input's device and with
    the dtype numpy's result has (the tensor's own, but for the mean of
    an integer tensor, which is float64 as in numpy). A tensor crosses
    to the host once (``.cpu()``) and back once (``.to(device)``); a
    dtype that numpy lacks (bf16) raises there.
    """

    def __init__(self, rank: int, size: int,
                 addrs: Sequence[Tuple[str, int]],
                 listener: Optional[pysocket.socket] = None) -> None:
        if size < 2:
            if listener is not None:
                listener.close()
            raise ValueError("HostRing needs size >= 2")
        self.rank = rank
        self.size = size
        ip, port = addrs[rank]
        if listener is None:
            # Prefer a pre-bound listener (see Ring's rendezvous: binding
            # before advertising eliminates port races between ranks that
            # share a machine).
            listener = pysocket.socket(pysocket.AF_INET,
                                       pysocket.SOCK_STREAM)
            listener.setsockopt(pysocket.SOL_SOCKET,
                                pysocket.SO_REUSEADDR, 1)
            listener.bind(("", port))
            listener.listen(2)

        next_ip, next_port = addrs[(rank + 1) % size]
        self._next: Optional[pysocket.socket] = None
        self._prev: Optional[pysocket.socket] = None

        def dial():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                try:
                    s = pysocket.create_connection((next_ip, next_port), 2.0)
                    s.setsockopt(pysocket.IPPROTO_TCP,
                                 pysocket.TCP_NODELAY, 1)
                    s.settimeout(None)
                    self._next = s
                    return
                except OSError:
                    time.sleep(0.1)

        t = threading.Thread(target=dial, daemon=True)
        t.start()
        listener.settimeout(60)
        conn, _ = listener.accept()
        conn.setsockopt(pysocket.IPPROTO_TCP, pysocket.TCP_NODELAY, 1)
        self._prev = conn
        t.join(60)
        listener.close()
        if self._next is None:
            raise OSError(f"rank {rank}: could not dial successor")

    # ------------------------------------------------------------------
    def _exchange(self, payload: bytes) -> bytes:
        """Send to successor while receiving from predecessor."""
        err: List[BaseException] = []

        def sender():
            try:
                send_frame(self._next, payload)
            except BaseException as e:  # noqa: BLE001 - re-raised below
                err.append(e)

        t = threading.Thread(target=sender, daemon=True)
        t.start()
        data = recv_frame(self._prev)
        t.join(120)
        if err:
            raise err[0]
        return data

    def allreduce(self, array, op: str = "sum"):
        """Two-phase ring allreduce; returns the reduced array (all ranks
        end with identical contents). ~2·(size-1)/size · bytes on the wire
        per rank — bandwidth-optimal."""
        import numpy as np

        if op not in ("sum", "mean"):
            raise ValueError(f"unsupported op {op!r}")
        arr, device = _to_host(array)
        shape, dtype = arr.shape, arr.dtype
        flat = arr.ravel()
        chunks = np.array_split(flat, self.size)
        rank, size = self.rank, self.size

        # Phase 1 — reduce-scatter: after size-1 steps, rank r owns the
        # fully-reduced chunk (r+1) % size.
        for step in range(size - 1):
            send_idx = (rank - step) % size
            recv_idx = (rank - step - 1) % size
            data = self._exchange(chunks[send_idx].tobytes())
            chunks[recv_idx] = chunks[recv_idx] + np.frombuffer(
                data, dtype=dtype
            )

        # Phase 2 — all-gather the reduced chunks around the ring.
        for step in range(size - 1):
            send_idx = (rank + 1 - step) % size
            recv_idx = (rank - step) % size
            data = self._exchange(chunks[send_idx].tobytes())
            chunks[recv_idx] = np.frombuffer(data, dtype=dtype)

        out = np.concatenate(chunks).reshape(shape)
        if op == "mean":
            out = out / size
        return _from_host(out, device)

    def broadcast(self, array, root: int = 0):
        """Ring broadcast from root (size-1 hops). Every rank passes an
        array (or tensor) of the root's shape and dtype; the root's
        contents come back."""
        import numpy as np

        arr, device = _to_host(array)
        if self.rank == root:
            arr = np.ascontiguousarray(arr)
            send_frame(self._next, arr.tobytes())
            # sink our own frame when it comes back around
            recv_frame(self._prev)
            return _from_host(arr, device)
        data = recv_frame(self._prev)
        out = np.frombuffer(data, dtype=arr.dtype).reshape(arr.shape)
        send_frame(self._next, data)
        return _from_host(out.copy(), device)

    def barrier(self) -> None:
        import numpy as np

        self.allreduce(np.zeros(1, dtype="float32"))

    def close(self) -> None:
        for s in (self._next, self._prev):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
