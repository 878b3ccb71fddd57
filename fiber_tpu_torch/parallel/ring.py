"""``Ring`` — SPMD process topology builder.

Counterpart of ``fiber_tpu/parallel/ring.py`` (reference parity:
fiber/experimental/ring.py: N processes running the same function with
(rank, size), rendezvous through a Manager list; the reference then
delegates collective setup to torch.distributed / Horovod via the user
initializer — examples/ring.py:141-174).

* ``default_initializer`` wires a ``HostRing``
  (``fiber_tpu_torch.ops.collectives``) over the rendezvous addresses,
  so ``current_ring().allreduce(grads)`` works with no framework at all.
  Neither it nor this module imports torch.
* ``torch_distributed_initializer``, in place of the JAX package's
  ``jax_distributed_initializer``, joins the ranks into one
  ``torch.distributed`` group over gloo, so that ``make_mesh(group=)``
  spans every rank's process and the ES runs across them.
"""

from __future__ import annotations

import random
import time
from typing import Callable, List, Optional, Tuple


class RingNode:
    def __init__(self, rank: int, ip: str = "", port: int = 0) -> None:
        self.rank = rank
        self.ip = ip
        self.port = port

    def __repr__(self) -> str:
        return f"RingNode(rank={self.rank}, ip={self.ip!r}, port={self.port})"


_current_ring = None
_pending_listener = None  # pre-bound rendezvous listener for this rank


def take_pending_listener():
    """The listener this rank bound before advertising its port (consumed
    by default_initializer; None if the rendezvous didn't pre-bind)."""
    global _pending_listener
    listener, _pending_listener = _pending_listener, None
    return listener


def current_ring():
    """The HostRing built by default_initializer in this rank's process."""
    if _current_ring is None:
        raise RuntimeError("no HostRing in this process "
                           "(did the Ring use default_initializer?)")
    return _current_ring


def default_initializer(rank: int, size: int,
                        addrs: List[Tuple[str, int]]) -> None:
    """Build the host-plane ring collective group for this rank."""
    global _current_ring
    from fiber_tpu_torch.ops.collectives import HostRing

    _current_ring = HostRing(rank, size, addrs,
                             listener=take_pending_listener())


# Marks initializers that consume the pre-bound rendezvous listener; all
# others get an unbound advertised port instead.
default_initializer._prebind = True  # type: ignore[attr-defined]


#: seconds that torch_distributed_initializer's store and collectives
#: wait for the other ranks before they raise
DIST_TIMEOUT_S = 120


def torch_distributed_initializer(rank: int, size: int,
                                  addrs: List[Tuple[str, int]]) -> None:
    """Join all ranks into one ``torch.distributed`` group over gloo:
    rank 0's advertised address holds the TCP store, served on the
    listener that rank 0 bound before it advertised the port (the
    ``_prebind`` rendezvous), so no other process can take the port in
    between, as it could when the store bound an advertised random port
    itself (it still does when called without a pre-bound listener). The
    other ranks close their own listeners unused. On a CUDA
    machine each rank first takes card ``rank % device_count`` as its
    current device. gloo, because NCCL refuses two ranks on one card. A
    rank that never arrives makes the store or the first collective
    raise after ``DIST_TIMEOUT_S`` seconds, never hang."""
    import datetime

    import torch
    import torch.distributed as dist

    if torch.cuda.is_available():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    ip, port = addrs[0]
    timeout = datetime.timedelta(seconds=DIST_TIMEOUT_S)
    listener = take_pending_listener()
    if rank == 0:
        # the store owns the listening socket from here on, and closes it
        fd = None if listener is None else listener.detach()
        store = dist.TCPStore(ip, port, size, True, timeout=timeout,
                              master_listen_fd=fd)
    else:
        if listener is not None:
            listener.close()
        store = dist.TCPStore(ip, port, size, False, timeout=timeout)
    dist.init_process_group("gloo", store=store, world_size=size,
                            rank=rank, timeout=timeout)


# Rank 0's store serves the listener bound before the port is advertised.
torch_distributed_initializer._prebind = True  # type: ignore[attr-defined]


def _ring_target(rank: int, size: int, nodes_proxy, func: Callable,
                 initializer: Optional[Callable]) -> None:
    import socket as pysocket

    from fiber_tpu_torch.backends import get_backend

    global _pending_listener

    ip, _, _ = get_backend().get_listen_addr()
    if getattr(initializer, "_prebind", False):
        # Bind BEFORE advertising: the reference advertises a random port
        # and binds later (ring.py:91-98), which races when ranks share a
        # machine. Only for initializers that consume the listener.
        listener = pysocket.socket(pysocket.AF_INET, pysocket.SOCK_STREAM)
        listener.setsockopt(pysocket.SOL_SOCKET, pysocket.SO_REUSEADDR, 1)
        listener.bind(("", 0))
        listener.listen(2)
        port = listener.getsockname()[1]
        _pending_listener = listener
    else:
        # The port is advertised for the initializer to bind itself: it
        # may be taken by the time it does.
        port = random.randint(30000, 50000)
    nodes_proxy[rank] = RingNode(rank, ip, port)

    deadline = time.monotonic() + 120
    while True:
        nodes = list(nodes_proxy)
        if all(n is not None for n in nodes):
            break
        if time.monotonic() > deadline:
            raise TimeoutError(f"rank {rank}: ring rendezvous timed out")
        time.sleep(0.05)
    nodes.sort(key=lambda n: n.rank)
    addrs = [(n.ip, n.port) for n in nodes]

    if initializer is not None:
        initializer(rank, size, addrs)
    leftover = take_pending_listener()
    if leftover is not None:  # initializer didn't consume it: release
        leftover.close()
    func(rank, size)


class Ring:
    """Launch ``size`` processes all running ``func(rank, size)`` after
    ``initializer(rank, size, addrs)`` has wired the collective group."""

    def __init__(self, size: int, func: Callable,
                 initializer: Optional[Callable] = default_initializer,
                 ) -> None:
        if size < 1:
            raise ValueError("ring size must be >= 1")
        self.size = size
        self.func = func
        self.initializer = initializer
        self.procs: list = []
        self._manager = None

    def run(self, join: bool = True) -> None:
        import fiber_tpu_torch
        from fiber_tpu_torch.meta import get_meta
        from fiber_tpu_torch.process import Process

        self._manager = fiber_tpu_torch.Manager()
        nodes = self._manager.list([None] * self.size)
        # Rank processes inherit the user function's @meta hints (cpu/mem/
        # tpu) even though their direct target is the rendezvous shim
        # (reference forwards them the same way, experimental/ring.py:78-82).
        hints = get_meta(self.func)
        self.procs = [
            Process(
                target=_ring_target,
                args=(rank, self.size, nodes, self.func, self.initializer),
                name=f"RingRank-{rank}",
                meta_hints=hints or None,
            )
            for rank in range(self.size)
        ]
        for p in self.procs:
            p.start()
        if join:
            self.join()

    def join(self, timeout: Optional[float] = None) -> None:
        try:
            for p in self.procs:
                p.join(timeout)
                if p.exitcode not in (0, None):
                    raise RuntimeError(
                        f"ring rank process {p.name} exited with "
                        f"{p.exitcode}"
                    )
        finally:
            if self._manager is not None:
                self._manager.shutdown()
                self._manager = None
