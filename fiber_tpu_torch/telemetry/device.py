"""Device telemetry plane: visibility into the device boundary.

The port's counterpart of ``fiber_tpu/telemetry/device.py``, with the
same surface, snapshot fields and registry names, so that the monitor's
``hbm_fill`` and ``recompile_storm`` rules read the same fields:

* **Transfer accounting** — :func:`transfer` wraps the host->device
  boundary (store resolution, the tensor reducer's rebuild, the
  ``device_map`` batch, the store's device tier) and records per-site
  ``device_transfer_seconds`` / ``device_transfer_bytes`` histograms,
  a tracing span when a trace context is ambient, and a flight event.
* **Compile observability** — PyTorch has no compiler to listen to, so
  :meth:`DeviceTelemetry.install_listeners` returns False and compiles
  come only through :meth:`DeviceTelemetry.note_compile`, which
  ``device_map`` calls on every miss of its plan cache. The same
  fingerprint recurring inside the storm window feeds the watchdog's
  ``recompile_storm`` rule.
* **Device gauges** — HBM in use (``torch.cuda.memory_allocated``) and
  capacity (``torch.cuda.mem_get_info``) of the current CUDA device, and
  live tensor bytes (``memory_allocated`` again; torch has no count of
  live arrays, so the count is ``None``), pushed into the registry each
  monitor tick.
* **Live MFU** — whenever the device's peak resolves
  (:mod:`fiber_tpu_torch.utils.flops`), per-map achieved FLOP/s divide
  into the ``pool_map_mfu`` gauge; CPU runs record ``None``.

No probe may initialize CUDA: with torch not imported, or CUDA not yet
initialized in this process, every device field is ``None``. Such a
process (a host agent, which never makes a CUDA context) reports its
host's card under a key of its own, ``card_hbm``: the first visible
card's memory in use by every process, and its capacity, as NVML sees
them where the driver's NVML library loads (else ``None``). Only the
``devices`` and ``top`` tables read it; the ``hbm`` pair, which the
``hbm_fill`` rule reads, stays this process's own allocator. Off
(``device_telemetry_enabled=False`` or the telemetry master switch),
every hook is one attribute check. :func:`snapshot` is picklable: it is
the payload of the host agent's ``device_snapshot`` op, the worker's
``("dev", ...)`` result-stream frames and ``Pool.device_stats()``.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import ctypes
import os
import sys
import threading
import time
from typing import Any, Dict, Iterator, Optional, Tuple

from fiber_tpu_torch import telemetry
from fiber_tpu_torch.telemetry import tracing
from fiber_tpu_torch.telemetry.flightrec import FLIGHT

# Registry twins (docs/observability.md metric catalog). Histograms for
# both axes: the bucket shape answers "are transfers many-small or
# few-huge" and sum/count give the totals the snapshots expose.
_m_transfer_seconds = telemetry.histogram(
    "device_transfer_seconds",
    "Host->device transfer boundary seconds, by site",
    buckets=(0.0001, 0.001, 0.01, 0.1, 1.0, 10.0))
_m_transfer_bytes = telemetry.histogram(
    "device_transfer_bytes",
    "Host->device transfer boundary payload bytes, by site",
    buckets=(1 << 10, 1 << 16, 1 << 20, 1 << 24, 1 << 28))
_m_compiles = telemetry.counter(
    "device_compiles",
    "Compilations noted in this process (device_map plan-cache misses)")
_m_compile_seconds = telemetry.counter(
    "device_compile_seconds", "Compilation seconds noted in this process")
_g_hbm_in_use = telemetry.gauge(
    "device_hbm_bytes_in_use", "HBM bytes in use on the current CUDA device")
_g_hbm_limit = telemetry.gauge(
    "device_hbm_bytes_limit", "HBM byte capacity of the current CUDA device")
_g_live_arrays = telemetry.gauge(
    "device_live_arrays",
    "Live device array count in this process (never set on torch)")
_g_live_array_bytes = telemetry.gauge(
    "device_live_array_bytes", "Live CUDA tensor bytes in this process")
_g_map_mfu = telemetry.gauge(
    "pool_map_mfu",
    "MFU of the last device map whose device peak resolved")


class DeviceTelemetry:
    """Per-process device-plane aggregate; see module docstring."""

    def __init__(self) -> None:
        self.enabled = True
        self._lock = threading.Lock()
        # site -> [count, seconds, bytes]
        self._transfers: Dict[str, list] = {}
        #: Bumped on every recorded transfer/compile — workers ship a
        #: fresh snapshot on the result stream only when this moved.
        self.revision = 0
        # compile observability
        self._compiles = 0
        self._compile_seconds = 0.0
        self._fingerprints: Dict[str, int] = {}
        self._recompiles: "collections.deque" = collections.deque(
            maxlen=256)  # (mono, fingerprint)
        self.storm_count = 4
        self.storm_window_s = 30.0
        # last live-MFU observation (None values are honest nulls)
        self._mfu: Dict[str, Any] = {
            "mfu": None, "flops_per_sec": None, "peak_row": None,
            "items": None, "wall_s": None,
        }
        # last gauge probe (kept so snapshots are cheap + honest)
        self._hbm: Dict[str, Optional[int]] = {
            "bytes_in_use": None, "bytes_limit": None}
        self._live: Dict[str, Optional[int]] = {
            "count": None, "bytes": None}
        # the card as NVML sees it, probed only without a CUDA context
        self._card_hbm: Optional[Dict[str, int]] = None
        # last profiler capture (utils/profiling.trace notes it so
        # trace_dump can find it without being told)
        self._xla_trace: Optional[Tuple[str, float, float]] = None

    # -- transfer accounting -------------------------------------------
    @contextlib.contextmanager
    def transfer(self, site: str, nbytes: int = 0) -> Iterator[None]:
        """Time one host→device boundary crossing. Off, the cost is one
        attribute check; on, the observation lands in the registry
        histograms, the flight recorder, and (when a trace context is
        ambient — i.e. inside a traced chunk) a ``device.transfer``
        span so the transfer shows up in the map's timeline."""
        if not self.enabled:
            yield
            return
        span_ctx = (tracing.span("device.transfer", site=site,
                                 bytes=int(nbytes))
                    if tracing.current() is not None
                    else contextlib.nullcontext())
        t0 = time.perf_counter()
        try:
            with span_ctx:
                yield
        finally:
            self.add_transfer(site, time.perf_counter() - t0, nbytes)

    def add_transfer(self, site: str, seconds: float,
                     nbytes: int = 0) -> None:
        """Record one completed transfer (the non-context form)."""
        if not self.enabled:
            return
        nbytes = int(nbytes)
        with self._lock:
            agg = self._transfers.get(site)
            if agg is None:
                agg = self._transfers[site] = [0, 0.0, 0]
            agg[0] += 1
            agg[1] += seconds
            agg[2] += nbytes
            self.revision += 1
        _m_transfer_seconds.observe(seconds, site=site)
        _m_transfer_bytes.observe(float(nbytes), site=site)
        # Accounting plane: the transfer bills the map whose chunk is
        # ambient (the worker's store_resolve path), else overhead. The
        # `ici` site (device-tier placement/fan-out) bills its own field
        # too, so Pool.cost()/explain split blame: bytes that rode the
        # mesh vs bytes that crossed sockets.
        from fiber_tpu_torch.telemetry.accounting import COSTS

        if site == "ici":
            COSTS.bill_ambient(device_transfer_bytes=nbytes,
                               device_transfer_s=seconds,
                               ici_bytes=nbytes)
        else:
            COSTS.bill_ambient(device_transfer_bytes=nbytes,
                               device_transfer_s=seconds)
        if FLIGHT.enabled:
            FLIGHT.record("device", "transfer", site=site,
                          bytes=nbytes, s=round(seconds, 6))

    # -- compile observability -----------------------------------------
    def install_listeners(self) -> bool:
        """False: PyTorch emits no compile events to listen to. Kept for
        the JAX package's surface; compiles are noted by
        :meth:`note_compile`."""
        return False

    def note_compile(self, fingerprint: str) -> None:
        """One compilation (or compile-cache miss) of the logical
        program named by ``fingerprint``. The device_map plan calls this
        on every miss of its cache. The same fingerprint recurring
        inside ``storm_window_s`` is the recompile-storm signal."""
        if not self.enabled:
            return
        now = time.monotonic()
        with self._lock:
            self._compiles += 1
            self._fingerprints[fingerprint] = \
                self._fingerprints.get(fingerprint, 0) + 1
            if len(self._fingerprints) > 128:
                # Bound the table; a storm is about repeats, not breadth.
                self._fingerprints.pop(next(iter(self._fingerprints)))
            self._recompiles.append((now, fingerprint))
            self.revision += 1
        _m_compiles.inc()
        if FLIGHT.enabled:
            FLIGHT.record("device", "compile",
                          fingerprint=str(fingerprint)[:48],
                          count=self._fingerprints.get(fingerprint, 1))

    def recompile_state(self) -> Dict[str, Any]:
        """The watchdog's per-tick probe: is any single fingerprint
        compiling repeatedly inside the storm window?"""
        cutoff = time.monotonic() - float(self.storm_window_s)
        with self._lock:
            recent: Dict[str, int] = {}
            for mono, fp in self._recompiles:
                if mono >= cutoff:
                    recent[fp] = recent.get(fp, 0) + 1
        if not recent:
            return {"storm": False, "fingerprint": None, "count": 0}
        fp = max(recent, key=recent.get)
        return {"storm": recent[fp] >= int(self.storm_count),
                "fingerprint": fp, "count": recent[fp],
                "window_s": float(self.storm_window_s)}

    # -- device gauges --------------------------------------------------
    def update_gauges(self) -> None:
        """Refresh HBM / live-tensor gauges (the monitor sampler's
        per-tick probe). Never initializes CUDA: before this process has
        used it every field stays None — honest, not zero — and the
        card's NVML reading goes to ``card_hbm`` alone."""
        if not self.enabled:
            return
        hbm = _hbm_stats()
        live = _live_array_stats()
        card = None if _devices() else _card_hbm_stats()
        with self._lock:
            self._hbm = hbm
            self._live = live
            self._card_hbm = card
        if hbm["bytes_in_use"] is not None:
            _g_hbm_in_use.set(float(hbm["bytes_in_use"]))
        if hbm["bytes_limit"] is not None:
            _g_hbm_limit.set(float(hbm["bytes_limit"]))
        if live["count"] is not None:
            _g_live_arrays.set(float(live["count"]))
        if live["bytes"] is not None:
            _g_live_array_bytes.set(float(live["bytes"]))

    # -- live MFU -------------------------------------------------------
    def note_map_flops(self, flops: float, wall_s: float,
                       items: int) -> Optional[float]:
        """One device map finished having executed ``flops`` analytic
        FLOPs in ``wall_s``. When the device peak resolves
        (utils/flops.py — a CUDA card in its table, or FIBER_PEAK_FLOPS), the MFU
        lands in the ``pool_map_mfu`` gauge; otherwise the observation
        records ``mfu: None`` honestly (CPU posture). Returns the MFU
        or None."""
        if not self.enabled or wall_s <= 0:
            return None
        from fiber_tpu_torch.utils import flops as flopsmod

        value = None
        fps = float(flops) / wall_s
        peak = {"peak_row": None}
        try:
            devices = _devices()
            if devices:
                value = flopsmod.mfu(fps, devices)
                peak = flopsmod.peak_report(devices)
        except Exception:  # noqa: BLE001 - accounting must not fail maps
            pass
        with self._lock:
            self._mfu = {"mfu": value, "flops_per_sec": fps,
                         "peak_row": peak.get("peak_row"),
                         "items": int(items), "wall_s": round(wall_s, 6)}
            self.revision += 1
        if value is not None:
            _g_map_mfu.set(float(value))
        if FLIGHT.enabled:
            FLIGHT.record("device", "mfu", mfu=value,
                          flops_per_sec=round(fps, 3),
                          peak_row=peak.get("peak_row"))
        return value

    # -- unified timeline ----------------------------------------------
    def note_xla_trace(self, log_dir: str, wall_start: float,
                       mono_start: float) -> None:
        """utils/profiling.trace records where ``torch.profiler`` wrote
        its capture (and the wall clock at trace start), so
        ``Pool.trace_dump`` can merge the device timeline beside the
        host spans without being told the directory."""
        with self._lock:
            self._xla_trace = (str(log_dir), float(wall_start),
                               float(mono_start))

    def last_xla_trace(self) -> Optional[Tuple[str, float, float]]:
        with self._lock:
            return self._xla_trace

    # -- read side ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Picklable per-process device-plane surface (agent
        ``device_snapshot`` op / ``Pool.device_stats()`` / worker
        ``("dev", …)`` frames). Null fields are honest: this process
        has no device runtime, not 'zero bytes of HBM'."""
        with self._lock:
            transfers = {site: {"count": agg[0],
                                "seconds": round(agg[1], 6),
                                "bytes": agg[2]}
                         for site, agg in self._transfers.items()}
            out = {
                "host": tracing.host_id(),
                "pid": os.getpid(),
                "enabled": self.enabled,
                "revision": self.revision,
                "transfers": transfers,
                "transfer_bytes": sum(a[2]
                                      for a in self._transfers.values()),
                "transfer_seconds": round(
                    sum(a[1] for a in self._transfers.values()), 6),
                "compiles": self._compiles,
                "compile_seconds": round(self._compile_seconds, 6),
                "compile_fingerprints": dict(self._fingerprints),
                "hbm": dict(self._hbm),
                "live_arrays": dict(self._live),
                "mfu": dict(self._mfu),
                "card_hbm": (dict(self._card_hbm)
                             if self._card_hbm is not None else None),
            }
        out["recompile"] = self.recompile_state()
        out["platform"] = _platform()
        out["jax_monitoring"] = False
        return out

    def configure(self, cfg) -> None:
        """Follow the config knobs (telemetry.refresh)."""
        self.enabled = bool(cfg.telemetry_enabled) \
            and bool(cfg.device_telemetry_enabled)
        self.storm_count = max(2, int(cfg.anomaly_recompile_count))
        self.storm_window_s = max(1.0,
                                  float(cfg.anomaly_recompile_window_s))

    def clear(self) -> None:
        with self._lock:
            self._transfers.clear()
            self._compiles = 0
            self._compile_seconds = 0.0
            self._fingerprints.clear()
            self._recompiles.clear()
            self.revision = 0
            self._mfu = {"mfu": None, "flops_per_sec": None,
                         "peak_row": None, "items": None, "wall_s": None}
            self._hbm = {"bytes_in_use": None, "bytes_limit": None}
            self._live = {"count": None, "bytes": None}
            self._card_hbm = None
            self._xla_trace = None


# ---------------------------------------------------------------------------
# Null-safe device probes (never initialize CUDA, never raise)
# ---------------------------------------------------------------------------


#: held while a probe is inside ``torch.cuda``; see _stop_cuda_probes
_cuda_probe_lock = threading.RLock()
_cuda_probes_stopped = False


def _stop_cuda_probes(wait_s: float = 5.0) -> None:
    """Run at exit, before Python finalizes: wait for a probe that is
    inside ``torch.cuda`` (up to ``wait_s``) and let no probe enter it
    again. The monitor sampler is a daemon thread; if finalization
    begins while it is in a torch call that released the GIL, Python
    ends the thread with ``pthread_exit`` as it takes the GIL back, and
    that unwind through pybind11's GIL guard aborts the process
    ("terminate called without an active exception", exit -6)."""
    global _cuda_probes_stopped
    held = _cuda_probe_lock.acquire(timeout=wait_s)
    _cuda_probes_stopped = True
    if held:
        _cuda_probe_lock.release()


atexit.register(_stop_cuda_probes)


def _devices():
    """The current CUDA device, as a one-item list, or None while torch
    is not imported or CUDA not initialized in this process: probing
    must not pay for (or trigger) a CUDA context in a process that does
    no device work (host agents, host-plane workers). None too once
    :func:`_stop_cuda_probes` ran."""
    torch = sys.modules.get("torch")
    if torch is None:
        return None
    with _cuda_probe_lock:
        if _cuda_probes_stopped:
            return None
        try:
            if not torch.cuda.is_initialized():
                return None
            return [torch.device("cuda", torch.cuda.current_device())]
        except Exception:  # noqa: BLE001 - no device is a valid state
            return None


def _platform() -> Optional[str]:
    return "gpu" if _devices() else None


#: the NVML library once loaded and initialized; False once it failed
_nvml = None


class _NvmlMemory(ctypes.Structure):
    """``nvmlMemory_t``: bytes of the card's memory."""

    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


def _load_nvml():
    """The driver's NVML library, initialized, with its three functions'
    signatures declared."""
    lib = ctypes.CDLL("libnvidia-ml.so.1")
    lib.nvmlInit_v2.argtypes = []
    lib.nvmlInit_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
        ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
    lib.nvmlDeviceGetHandleByIndex_v2.restype = ctypes.c_int
    lib.nvmlDeviceGetMemoryInfo.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_NvmlMemory)]
    lib.nvmlDeviceGetMemoryInfo.restype = ctypes.c_int
    if lib.nvmlInit_v2() != 0:
        raise OSError("nvmlInit failed")
    return lib


def _nvml_memory() -> Optional[Tuple[int, int]]:
    """``(used, total)`` bytes of the first visible card as NVML sees
    them (``nvmlDeviceGetMemoryInfo``: every process's use, and the
    capacity), through ``ctypes`` as ``torch.cuda`` loads NVML itself;
    NVML makes no CUDA context. None without the library, a card, or
    a numeric first entry of ``CUDA_VISIBLE_DEVICES``."""
    global _nvml
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    index = 0
    if visible is not None:
        first = visible.split(",")[0].strip()
        if not first.isdigit():
            return None  # every card hidden, or named by UUID
        index = int(first)
    if _nvml is False:
        return None
    try:
        if _nvml is None:
            _nvml = _load_nvml()
        handle = ctypes.c_void_p()
        if _nvml.nvmlDeviceGetHandleByIndex_v2(
                ctypes.c_uint(index), ctypes.byref(handle)) != 0:
            return None
        mem = _NvmlMemory()
        if _nvml.nvmlDeviceGetMemoryInfo(handle, ctypes.byref(mem)) != 0:
            return None
        return int(mem.used), int(mem.total)
    except (OSError, AttributeError):
        _nvml = False
        return None


def _card_hbm_stats() -> Optional[Dict[str, int]]:
    """The first visible card's ``{"bytes_in_use", "bytes_limit"}`` as
    NVML reports them (:func:`_nvml_memory`: every process's use, the
    caching allocators' reserves included), or None."""
    card = _nvml_memory()
    if card is None:
        return None
    return {"bytes_in_use": card[0], "bytes_limit": card[1]}


def _hbm_stats() -> Dict[str, Optional[int]]:
    """The current CUDA device's ``{"bytes_in_use", "bytes_limit"}``:
    bytes the caching allocator has handed to tensors, and the card's
    capacity; both None without an initialized CUDA device."""
    with _cuda_probe_lock:
        devices = _devices()
        if not devices:
            return {"bytes_in_use": None, "bytes_limit": None}
        import torch

        try:
            return {
                "bytes_in_use": int(torch.cuda.memory_allocated(devices[0])),
                "bytes_limit": int(torch.cuda.mem_get_info(devices[0])[1]),
            }
        except Exception:  # noqa: BLE001 - platform-dependent surface
            return {"bytes_in_use": None, "bytes_limit": None}


def _live_array_stats() -> Dict[str, Optional[int]]:
    """``count`` is None (torch keeps no list of live tensors); ``bytes``
    is the allocator's bytes in use."""
    return {"count": None, "bytes": _hbm_stats()["bytes_in_use"]}


#: Process-wide device telemetry (knobs follow ``device_telemetry_*``
#: via telemetry.refresh()).
DEVICE = DeviceTelemetry()


def transfer(site: str, nbytes: int = 0):
    """Module-level convenience: ``with device.transfer("dmap", n): …``"""
    return DEVICE.transfer(site, nbytes)


def snapshot() -> Dict[str, Any]:
    return DEVICE.snapshot()
