"""``multiprocessing.connection``'s ``Client`` and ``Listener`` whose
connections pickle objects with the port's :mod:`fiber_tpu_torch.serialization`.

A stdlib ``Connection.send`` pickles with ``ForkingPickler``, on which
``import torch`` registers ``torch.multiprocessing``'s reducers: a CPU
tensor then travels as a shared-memory file descriptor, fetched back
from the sender's resource sharer under ``multiprocessing``'s own
authkey (which a fiber process does not share with its parent, so the
fetch is refused), and a CUDA tensor as a CUDA IPC handle, which a
receiver cannot send on. The managers serve objects that they receive
from one process to others, so their connections send tensors by value,
as the pool's wire does: :func:`serialization.dumps` out,
:func:`serialization.loads` in. Everything else of a connection (the
bytes methods that the authentication handshake uses, ``poll``,
``fileno``, ``close``) is the stdlib connection's.
"""

from __future__ import annotations

from multiprocessing import connection as _connection

from fiber_tpu_torch import serialization


class Connection:
    """A stdlib connection whose ``send``/``recv`` go through the port's
    serialization."""

    def __init__(self, conn) -> None:
        self._conn = conn

    def send(self, obj) -> None:
        self._conn.send_bytes(serialization.dumps(obj))

    def recv(self):
        return serialization.loads(self._conn.recv_bytes())

    def __getattr__(self, name):
        return getattr(self._conn, name)


def Client(address, family=None, authkey=None) -> Connection:
    """``multiprocessing.connection.Client``, its connection wrapped."""
    return Connection(_connection.Client(address, family, authkey))


class Listener:
    """``multiprocessing.connection.Listener`` whose ``accept`` returns
    wrapped connections."""

    def __init__(self, *args, **kwargs) -> None:
        self._listener = _connection.Listener(*args, **kwargs)

    def accept(self) -> Connection:
        return Connection(self._listener.accept())

    def __getattr__(self, name):
        return getattr(self._listener, name)
