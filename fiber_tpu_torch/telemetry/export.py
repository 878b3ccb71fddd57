"""Telemetry exporters: Chrome trace-event JSON (Perfetto / chrome://
tracing) and Prometheus v0.0.4 text exposition, plus the authenticated
metrics endpoint.

The Prometheus handler deliberately rides the SAME hardened
accept/authenticate plane as the host agent and managers server
(fiber_tpu_torch/utils/serve.py) instead of opening an unauthenticated HTTP
port: the metrics of a cluster that moves pickled closures around are
operator data, and every listening fiber_tpu_torch socket shares one threat
posture. Scrape with ``fiber-tpu metrics --hosts … --prom`` or any
client that speaks multiprocessing.connection with the cluster key.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional

from fiber_tpu_torch.telemetry import metrics as _metrics
from fiber_tpu_torch.utils.logging import get_logger

logger = get_logger()

#: Exposition content type (the v0.0.4 text format Prometheus scrapes).
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"

_PREFIX = "fiber_"


# ---------------------------------------------------------------------------
# Chrome trace-event JSON (load in Perfetto / chrome://tracing)
# ---------------------------------------------------------------------------


def chrome_trace(spans: List[Dict]) -> Dict:
    """Span dicts -> a Chrome trace-event JSON object. Mapping:
    pid = host (one process row per cluster host), tid = the worker
    process's OS pid on that host — so a pool map renders as the
    master's serialize span followed by per-worker execute lanes."""
    hosts: Dict[str, int] = {}
    events: List[Dict] = []
    for sp in spans:
        host = str(sp.get("host", "host"))
        pid = hosts.setdefault(host, len(hosts) + 1)
        tid = int(sp.get("pid", 0))
        args = {k: v for k, v in sp.items()
                if k not in ("name", "ts", "dur", "host", "pid")}
        events.append({
            "name": str(sp.get("name", "span")),
            "ph": "X",
            "ts": float(sp.get("ts", 0.0)) * 1e6,
            "dur": max(float(sp.get("dur", 0.0)), 1e-7) * 1e6,
            "pid": pid,
            "tid": tid,
            "cat": str(sp.get("name", "span")).split(".", 1)[0],
            "args": args,
        })
    meta = [
        {"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
         "args": {"name": host}}
        for host, pid in hosts.items()
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_chrome_trace(path: str, spans: List[Dict],
                       xla_dir: Optional[str] = None,
                       xla_wall_start: Optional[float] = None) -> str:
    """Write spans as Chrome trace JSON; with ``xla_dir`` the newest
    ``torch.profiler`` capture under it (``utils.profiling.trace``
    output) is merged in so the card's kernels and copies render beside
    the host spans — the unified timeline. The argument names are the
    JAX package's, whose captures are XLA's."""
    doc = chrome_trace(spans)
    if xla_dir:
        merge_xla_trace(doc, xla_dir, wall_start=xla_wall_start)
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return path


# ---------------------------------------------------------------------------
# Unified host+device timeline: merge a torch.profiler capture
# ---------------------------------------------------------------------------

#: Profiler event categories that run on the card: a lane (profiler
#: pid) holding any of them is a device lane.
DEVICE_CATEGORIES = frozenset(("kernel", "gpu_memcpy", "gpu_memset",
                               "gpu_user_annotation"))

#: Lane name prefixes of a merged capture: ``CUDA`` for the card's
#: lanes, ``torch`` for the profiler's host lanes (the JAX package
#: prefixes every XLA lane ``XLA``).
DEVICE_LANE_PREFIX = "CUDA"
HOST_LANE_PREFIX = "torch"


def find_xla_chrome_trace(log_dir: str) -> Optional[str]:
    """Newest profiler Chrome trace under ``log_dir``: the
    ``trace.json`` (:data:`utils.profiling.TRACE_FILE`) that
    ``utils.profiling.trace`` writes, or a ``*.trace.json[.gz]`` as
    ``torch.profiler.tensorboard_trace_handler`` names its files;
    None when there is none."""
    from fiber_tpu_torch.utils.profiling import TRACE_FILE

    newest: Optional[str] = None
    newest_mtime = -1.0
    for root, _dirs, files in os.walk(log_dir):
        for name in files:
            if not (name == TRACE_FILE or name.endswith(".trace.json.gz")
                    or name.endswith(".trace.json")):
                continue
            path = os.path.join(root, name)
            try:
                mtime = os.path.getmtime(path)
            except OSError:
                continue
            if mtime > newest_mtime:
                newest, newest_mtime = path, mtime
    return newest


def load_xla_chrome_trace(path: str) -> Optional[Dict]:
    """Parse one profiler Chrome trace file (plain or gzipped); None
    when the file is unreadable or not a trace (merging is best-effort
    — a missing device capture must never fail a host trace dump)."""
    import gzip

    try:
        opener = gzip.open if path.endswith(".gz") else open
        with opener(path, "rt") as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return None
    return doc


def _lane_number(value, lanes: Dict) -> int:
    """A lane's number: the next free one for each distinct id, so that
    ids of any type (Kineto's ints, its empty-string pids of instant
    events, names) map to the integers Chrome traces expect."""
    key = (type(value).__name__, str(value))
    return lanes.setdefault(key, len(lanes))


def merge_xla_trace(doc: Dict, log_dir: str,
                    wall_start: Optional[float] = None) -> int:
    """Merge the newest ``torch.profiler`` capture under ``log_dir``
    into a host Chrome-trace ``doc`` (chrome_trace output), in place.
    Host spans carry wall-epoch timestamps; profiler events carry the
    profiler's own µs origin — with ``wall_start`` (the wall clock when
    the capture began, noted by ``utils.profiling.trace``) they are
    rebased onto the wall axis so both planes line up; without it they
    are rebased to the host trace's start. Where the capture states its
    wall-epoch base (Kineto's ``baseTimeNanoseconds``), the base places
    them instead, unless it disagrees with a given ``wall_start`` by 10
    minutes or more.

    Every profiler pid becomes a lane numbered past the host rows, and
    every tid a number within its lane, whatever their type: Kineto
    writes integer pids for the host and the card, but empty strings
    for its window markers. Each lane gets one ``process_name`` row:
    ``CUDA <name>`` for a lane holding the card's events
    (:data:`DEVICE_CATEGORIES`), ``torch <name>`` for the profiler's
    host lanes, named by the capture's ``process_labels`` row (Kineto's
    ``GPU 0``, ``CPU``), else its ``process_name`` row, else the
    original pid.
    Returns the number of profiler events merged (0 = no capture found;
    never raises)."""
    try:
        path = find_xla_chrome_trace(log_dir)
        if path is None:
            return 0
        trace = load_xla_chrome_trace(path)
        if trace is None:
            return 0
        host_events = doc.setdefault("traceEvents", [])
        pid_base = max((int(e.get("pid", 0)) for e in host_events),
                       default=0) + 1000
        events = [e for e in trace.get("traceEvents", [])
                  if isinstance(e, dict) and "ph" in e]
        timed = [float(e["ts"]) for e in events if "ts" in e]
        t0 = min(timed) if timed else 0.0
        base_ns = trace.get("baseTimeNanoseconds")
        if isinstance(base_ns, (int, float)) and (
                wall_start is None or abs(base_ns / 1e3 + t0
                                          - float(wall_start) * 1e6)
                < 600e6):
            # Kineto's timestamps count from this wall-epoch base: the
            # events then sit on the host spans' axis as recorded.
            offset_us = base_ns / 1e3
        else:
            if wall_start is None:
                wall_start = min(
                    (float(e["ts"]) / 1e6 for e in host_events
                     if e.get("ph") == "X"), default=0.0)
            offset_us = float(wall_start) * 1e6 - t0
        lanes: Dict = {}
        tids: Dict = {}
        names: Dict[int, str] = {}
        pids: Dict[int, str] = {}
        labels: Dict[int, str] = {}
        device_lanes = set()
        merged = []
        for ev in events:
            # Chrome trace arrays may end with a bare {} (and some
            # producers emit phase-less entries); a merged artifact must
            # stay iterable by strict consumers, so those were dropped.
            ev = dict(ev)
            lane = _lane_number(ev.get("pid", ""), lanes)
            pids.setdefault(lane, str(ev.get("pid", "")))
            ev["pid"] = pid_base + lane
            if "tid" in ev:
                ev["tid"] = _lane_number(
                    ev["tid"], tids.setdefault(lane, {}))
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                names.setdefault(lane, str(
                    (ev.get("args") or {}).get("name", "")))
                continue
            if ev.get("ph") == "M" and ev.get("name") == "process_labels":
                labels.setdefault(lane, str(
                    (ev.get("args") or {}).get("labels", "")))
            if ev.get("cat") in DEVICE_CATEGORIES:
                device_lanes.add(lane)
            if "ts" in ev:
                ev["ts"] = float(ev["ts"]) + offset_us
            merged.append(ev)
        for lane in sorted(set(lanes.values())):
            prefix = (DEVICE_LANE_PREFIX if lane in device_lanes
                      else HOST_LANE_PREFIX)
            name = (labels.get(lane) or names.get(lane) or pids.get(lane)
                    or f"lane {lane}")
            host_events.append(
                {"ph": "M", "name": "process_name", "pid": pid_base + lane,
                 "tid": 0, "args": {"name": f"{prefix} {name}"}})
        host_events.extend(merged)
        return len(merged)
    except Exception:  # noqa: BLE001 - merging is strictly best-effort
        logger.exception("telemetry: profiler trace merge failed; "
                         "writing host spans only")
        return 0


# ---------------------------------------------------------------------------
# Prometheus v0.0.4 text exposition
# ---------------------------------------------------------------------------


def _prom_name(name: str, kind: str) -> str:
    full = name if name.startswith(_PREFIX) else _PREFIX + name
    if kind == "counter" and not full.endswith("_total"):
        full += "_total"
    return full


def _prom_labels(key: str, extra: str = "") -> str:
    parts = [p for p in (extra, key) if p]
    if not parts:
        return ""
    rendered = []
    for part in parts:
        for pair in part.split(","):
            k, _, v = pair.partition("=")
            v = v.replace("\\", "\\\\").replace('"', '\\"')
            rendered.append(f'{k}="{v}"')
    return "{" + ",".join(rendered) + "}"


def prometheus_text(snapshot: Optional[Dict[str, dict]] = None) -> str:
    """Render a ``registry.snapshot()`` dict (default: the process
    registry) as Prometheus v0.0.4 text exposition."""
    if snapshot is None:
        from fiber_tpu_torch import telemetry

        snapshot = telemetry.REGISTRY.snapshot()
    lines: List[str] = []
    for name in sorted(snapshot):
        entry = snapshot[name]
        kind = entry.get("type", "untyped")
        full = _prom_name(name, kind)
        if entry.get("help"):
            lines.append(f"# HELP {full} {entry['help']}")
        lines.append(f"# TYPE {full} "
                     f"{kind if kind != 'untyped' else 'untyped'}")
        series = entry.get("series", {})
        if kind == "histogram":
            bounds = entry.get("buckets", [])
            for key in sorted(series):
                values = series[key]
                cum = 0
                for i, bound in enumerate(bounds):
                    cum += values[i]
                    lines.append(
                        f"{full}_bucket"
                        f"{_prom_labels(key, f'le={bound:g}')} {cum}")
                cum += values[len(bounds)]
                lines.append(
                    f"{full}_bucket{_prom_labels(key, 'le=+Inf')} {cum}")
                lines.append(f"{full}_sum{_prom_labels(key)} "
                             f"{values[-2]:g}")
                lines.append(f"{full}_count{_prom_labels(key)} "
                             f"{values[-1]}")
        else:
            for key in sorted(series):
                lines.append(f"{full}{_prom_labels(key)} "
                             f"{float(series[key]):g}")
    return "\n".join(lines) + "\n"


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Minimal exposition parser (tests + CLI sanity): sample name with
    its label string -> value. Raises ValueError on malformed lines."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        name_part, _, value_part = line.rpartition(" ")
        if not name_part:
            raise ValueError(f"malformed exposition line: {line!r}")
        out[name_part] = float(value_part)
    return out


# ---------------------------------------------------------------------------
# Authenticated metrics endpoint
# ---------------------------------------------------------------------------


class MetricsServer:
    """Serves this process's telemetry over the authenticated RPC plane:
    request ``("metrics",)`` -> Prometheus text, ``("snapshot",)`` ->
    the raw telemetry snapshot dict. Same HMAC challenge + hardened
    accept loop as the host agent."""

    def __init__(self, port: int = 0, bind: str = "127.0.0.1",
                 authkey: Optional[bytes] = None) -> None:
        from multiprocessing.connection import Listener

        from fiber_tpu_torch.auth import cluster_key

        if (bind not in ("127.0.0.1", "localhost")
                and authkey is None
                and "FIBER_CLUSTER_KEY" not in os.environ):
            raise RuntimeError(
                "metrics server: refusing to bind non-loopback interface "
                f"{bind!r} with the default cluster key; set "
                "FIBER_CLUSTER_KEY or bind 127.0.0.1")
        self._authkey = authkey or cluster_key()
        self._listener = Listener((bind, port))
        self.port = self._listener.address[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._serve, name="fiber-torch-metrics-serve", daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        from fiber_tpu_torch.utils.serve import serve_request_reply

        serve_request_reply(self._listener, self._authkey, self._stop,
                            self._answer, "fiber-torch-metrics-conn")

    def _answer(self, request):
        from fiber_tpu_torch import telemetry

        op = request[0] if isinstance(request, tuple) else request
        if op == "metrics":
            return prometheus_text()
        if op == "snapshot":
            return telemetry.snapshot()
        raise ValueError(f"unknown metrics op {op!r}")

    def stop(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
