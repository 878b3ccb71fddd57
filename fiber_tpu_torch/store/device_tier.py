"""Device-resident store tier: broadcast payloads live on the card.

The port's counterpart of ``fiber_tpu/store/device_tier.py``. The host
object store (core.py / plane.py) ends every resolution at the
host->device boundary; this tier is a bounded LRU of ``digest ->
(device-resident pytree, per-leaf metadata)`` in front of it, so the
resolution order becomes device tier -> host RAM -> disk -> wire. A
master that maps the same broadcast payload generation after generation
pays its host-to-device copy once.

On the port's single-controller mesh every rank sits on one card, so a
put is one host-to-device copy with no fan-out: it is accounted as
``nbytes`` under the ``ici`` transfer site (``DEVICE.transfer``), where
the JAX package, replicating over a mesh of devices, accounts
``n_dev x nbytes``.

Capacity discipline mirrors :class:`fiber_tpu_torch.store.core.LocalStore`:
``refs`` are lifecycle hints, ``pins`` are hard (a pinned entry is never
evicted), and eviction walks LRU order. Eviction never loses data — the
host tiers still hold the serialized bytes, so dropping a device copy
only costs the next resolution one copy. The ``hbm_fill`` watchdog rule
(telemetry/monitor.py) demotes the tier under HBM pressure: every
unpinned entry is dropped, a ``store``/``remediate`` flight event records
the action, and resolutions fall through to the host tiers until the
rule clears and the tier re-promotes.

Per process by design: a CUDA tensor is not shared across processes here
(the tensor reducer sends bytes, never IPC handles).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from fiber_tpu_torch import telemetry
from fiber_tpu_torch.telemetry.flightrec import FLIGHT
from fiber_tpu_torch.utils.logging import get_logger

logger = get_logger()

# Registry twins (docs/observability.md metric catalog): the same
# counters ``stats()`` exposes, mirrored so cluster_metrics / the
# Prometheus endpoint see device-tier behavior without a store RPC.
_m_dev_puts = telemetry.counter(
    "store_device_puts", "Objects placed into the device store tier")
_m_dev_hits = telemetry.counter(
    "store_device_hits", "Device store tier resolution hits")
_m_dev_evictions = telemetry.counter(
    "store_device_evictions",
    "Device store tier entries dropped, by cause")
_g_dev_bytes = telemetry.gauge(
    "store_device_bytes", "Device store tier resident bytes")


def _leaf_meta(leaf) -> Optional[Dict[str, Any]]:
    """Metadata of one device-resident leaf: shape, dtype, bytes and
    device. ``sharding`` is None (the single-controller mesh keeps one
    copy) and ``replicated`` True: every rank reads the one copy."""
    shape = getattr(leaf, "shape", None)
    dtype = getattr(leaf, "dtype", None)
    if shape is None or dtype is None:
        return None
    nbytes = getattr(leaf, "nbytes", None)
    return {
        "shape": tuple(shape), "dtype": str(dtype),
        "nbytes": int(nbytes if nbytes is not None else 0),
        "sharding": None, "replicated": True,
        "device": str(getattr(leaf, "device", "cpu")),
    }


class _DevEntry:
    __slots__ = ("obj", "nbytes", "refs", "pins", "meta")

    def __init__(self, obj: Any, nbytes: int, refs: int,
                 meta: List[Optional[Dict[str, Any]]]) -> None:
        self.obj = obj
        self.nbytes = int(nbytes)
        self.refs = int(refs)
        self.pins = 0
        self.meta = meta


class DeviceTier:
    """HBM-budgeted LRU of digest -> device-resident object; see module
    docstring. All torch imports are lazy — building the tier in a
    process that never resolves device payloads costs nothing."""

    def __init__(self, capacity_bytes: int = 256 << 20,
                 device=None) -> None:
        self.capacity = int(capacity_bytes)
        #: where :meth:`put` places a payload whose caller names no
        #: device (None: the current CUDA device); a store resolution
        #: with ``device=True`` names none
        self.device = device
        self._lock = threading.RLock()
        self._entries: "Dict[str, _DevEntry]" = {}
        self._order: List[str] = []  # LRU: oldest first
        self._demoted = False
        self._demote_reason = ""
        self._stats: Dict[str, int] = {
            "puts": 0, "hits": 0, "misses": 0, "evictions": 0,
            "bytes": 0, "demotions": 0, "put_dedup_hits": 0,
        }

    # -- placement ------------------------------------------------------
    def put(self, digest: str, obj: Any, refs: int = 0,
            device=None) -> Any:
        """Place ``obj`` (a host pytree) into the tier under ``digest``:
        every numpy leaf of at least one dimension, and every tensor,
        moves to ``device`` (:attr:`device` when None), as
        ``device_map`` would move it; the
        device-resident pytree is returned (and cached). A demoted or
        zero-capacity tier returns ``obj`` untouched. The copy is
        accounted as the host bytes under the ``ici`` site."""
        with self._lock:
            if self._demoted or self.capacity <= 0:
                return obj
            entry = self._entries.get(digest)
            if entry is not None:
                self._stats["put_dedup_hits"] += 1
                self._touch(digest)
                return entry.obj
        import numpy as np
        import torch
        from torch.utils import _pytree as pytree

        from fiber_tpu_torch.device import resolve_device
        from fiber_tpu_torch.parallel.dmap import _to_device
        from fiber_tpu_torch.telemetry.device import DEVICE

        dev = resolve_device(self.device if device is None else device)
        leaves, spec = pytree.tree_flatten(obj)
        nbytes = sum(int(leaf.nbytes) for leaf in leaves
                     if isinstance(leaf, (np.ndarray, np.generic,
                                          torch.Tensor)))
        with DEVICE.transfer("ici", nbytes):
            dev_leaves = [
                _to_device(leaf, dev)
                if torch.is_tensor(leaf) or (
                    isinstance(leaf, np.ndarray) and leaf.ndim > 0)
                else leaf
                for leaf in leaves
            ]
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        dev_obj = pytree.tree_unflatten(dev_leaves, spec)
        meta = [_leaf_meta(leaf) for leaf in dev_leaves]
        with self._lock:
            if self._demoted:
                return dev_obj  # raced a demotion: hand back, don't cache
            existing = self._entries.get(digest)
            if existing is not None:
                self._stats["put_dedup_hits"] += 1
                self._touch(digest)
                return existing.obj
            self._entries[digest] = _DevEntry(dev_obj, nbytes, refs, meta)
            self._order.append(digest)
            self._stats["puts"] += 1
            self._stats["bytes"] += nbytes
            self._evict_locked()
            _g_dev_bytes.set(float(self._stats["bytes"]))
        _m_dev_puts.inc()
        return dev_obj

    def get(self, digest: str, pin: bool = False) -> Optional[Any]:
        """The device-resident object for ``digest``, or None (miss /
        demoted). A hit refreshes LRU order."""
        with self._lock:
            if self._demoted:
                return None
            entry = self._entries.get(digest)
            if entry is None:
                self._stats["misses"] += 1
                return None
            if pin:
                entry.pins += 1
            self._touch(digest)
            self._stats["hits"] += 1
        _m_dev_hits.inc()
        return entry.obj

    def meta(self, digest: str) -> Optional[List[Optional[Dict[str, Any]]]]:
        """Per-leaf metadata of a resident entry (shape, dtype, bytes,
        device), or None on miss."""
        with self._lock:
            entry = self._entries.get(digest)
            return None if entry is None else list(entry.meta)

    def contains(self, digest: str) -> bool:
        with self._lock:
            return not self._demoted and digest in self._entries

    # -- lifecycle (LocalStore parity) ----------------------------------
    def add_ref(self, digest: str, n: int = 1) -> None:
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                entry.refs += n

    def release(self, digest: str, n: int = 1) -> None:
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                entry.refs = max(0, entry.refs - n)

    def unpin(self, digest: str) -> None:
        with self._lock:
            entry = self._entries.get(digest)
            if entry is not None:
                entry.pins = max(0, entry.pins - 1)

    def delete(self, digest: str) -> None:
        with self._lock:
            self._drop_locked(digest, cause="delete")
            _g_dev_bytes.set(float(self._stats["bytes"]))

    def _touch(self, digest: str) -> None:
        try:
            self._order.remove(digest)
        except ValueError:
            pass
        self._order.append(digest)

    def _drop_locked(self, digest: str, cause: str) -> None:
        entry = self._entries.pop(digest, None)
        if entry is None:
            return
        try:
            self._order.remove(digest)
        except ValueError:
            pass
        self._stats["bytes"] = max(0, self._stats["bytes"] - entry.nbytes)
        self._stats["evictions"] += 1
        _m_dev_evictions.inc(cause=cause)

    def _evict_locked(self) -> None:
        """LRU walk past capacity. Pins are untouchable; refs do NOT
        protect (unlike the host store there is nothing to spill — the
        host tiers still hold the bytes, so dropping a device copy only
        costs the next resolution one copy)."""
        if self._stats["bytes"] <= self.capacity:
            return
        for digest in list(self._order):
            if self._stats["bytes"] <= self.capacity:
                break
            entry = self._entries.get(digest)
            if entry is None or entry.pins > 0:
                continue
            self._drop_locked(digest, cause="capacity")

    # -- closed-loop remediation (hbm_fill watchdog rule) ----------------
    def demote(self, reason: str = "hbm_fill") -> int:
        """Drop every unpinned entry and stop admitting new ones — the
        ``hbm_fill`` remediation (telemetry/monitor.py). Returns the
        bytes freed. Resolutions fall through to host RAM/disk/wire, so
        in-flight maps lose nothing; flight-evented so the postmortem
        trail shows the watchdog ACTED, not just observed."""
        with self._lock:
            if self._demoted:
                return 0
            freed = 0
            dropped = 0
            for digest in list(self._order):
                entry = self._entries.get(digest)
                if entry is None or entry.pins > 0:
                    continue
                freed += entry.nbytes
                dropped += 1
                self._drop_locked(digest, cause="demote")
            self._demoted = True
            self._demote_reason = str(reason)
            self._stats["demotions"] += 1
            _g_dev_bytes.set(float(self._stats["bytes"]))
        FLIGHT.record("store", "remediate", rule=str(reason),
                      action="demote_device_tier", dropped=dropped,
                      bytes=freed)
        logger.warning(
            "store: device tier demoted to host RAM (%s) — dropped %d "
            "entries / %d bytes; resolutions fall through to the host "
            "tiers", reason, dropped, freed)
        return freed

    def promote(self) -> None:
        """Re-admit entries (the breach cleared). Flight-evented like
        the demotion so the remediation window is visible end to end."""
        with self._lock:
            if not self._demoted:
                return
            self._demoted = False
            reason, self._demote_reason = self._demote_reason, ""
        FLIGHT.record("store", "remediate", rule=reason,
                      action="promote_device_tier")
        logger.info("store: device tier re-promoted (%s cleared)", reason)

    @property
    def demoted(self) -> bool:
        with self._lock:
            return self._demoted

    # -- read side ------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        with self._lock:
            out = dict(self._stats)
            out["entries"] = len(self._entries)
            out["capacity_bytes"] = self.capacity
            out["demoted"] = int(self._demoted)
        return out

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._order.clear()
            self._demoted = False
            self._demote_reason = ""
            for key in self._stats:
                self._stats[key] = 0
            _g_dev_bytes.set(0.0)
