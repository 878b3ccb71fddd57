"""Write-ahead map ledger: the durability layer under ``Pool.map(...,
job_id=...)`` (docs/robustness.md, "Durable maps").

The one failure domain the process/health/store planes cannot survive is
the **master itself**: a multi-hour ES/POET run dies with the process
that submitted it. The ledger closes that hole with the lineage posture
of Ray's fault-tolerance design — *recompute only what was lost, never
re-run what completed*:

* On submit, the map's **header** (task digest, chunking, trace id, and
  the content address of a resumable spec payload) is written — fsync'd
  — to an append-only file ``<staging>/ledger/<job_id>.ledger`` before
  the first chunk is dispatched.
* On each completed chunk, the master serializes the chunk's result
  values, persists them into the host object store's disk tier
  (``<staging>/objects/<digest>.obj`` — the same content-addressed
  cache agents serve), and appends a ``chunk`` record referencing the
  digest. Both happen on a dedicated writer thread: the result hot loop
  pays **one buffered append**, and fsyncs are batched per drain
  (``ledger_fsync_s``).
* On completion a ``done`` record closes the file.

Recovery — ``fiber-tpu resume <job_id>`` or re-calling ``map`` with the
same ``job_id`` — loads the ledger (tolerating a torn tail line from
the crash instant), restores every journaled chunk's results by digest
(local disk first, then the per-host caches via the backend's
``fetch_object``), and resubmits **only** the remainder. Records are
JSON lines, so ledgers are greppable operator artifacts as well as
recovery inputs.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from fiber_tpu_torch import serialization
from fiber_tpu_torch.store.core import digest_of
from fiber_tpu_torch.telemetry.flightrec import FLIGHT
from fiber_tpu_torch.utils.logging import get_logger

logger = get_logger()

#: Record schema version (bump on incompatible layout changes; load
#: refuses newer versions loudly instead of misreading them).
LEDGER_VERSION = 1

_JOB_ID_OK = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789._-")


def check_job_id(job_id: str) -> str:
    """Job ids become file names under the staging root, so anything
    path-shaped is rejected before it touches the filesystem."""
    if (not isinstance(job_id, str) or not job_id
            or len(job_id) > 128 or not set(job_id) <= _JOB_ID_OK):
        raise ValueError(
            f"invalid job_id {job_id!r}: use 1-128 chars from "
            "[A-Za-z0-9._-]")
    return job_id


def default_ledger_dir() -> str:
    """``ledger_dir`` config, or ``<staging root>/ledger`` — beside the
    ``objects/`` cache the journaled result payloads persist into."""
    from fiber_tpu_torch import config

    configured = str(config.get().ledger_dir or "")
    if configured:
        return os.path.realpath(configured)
    from fiber_tpu_torch.host_agent import default_staging_root

    return os.path.join(os.path.realpath(default_staging_root()), "ledger")


def job_path(job_id: str, ledger_dir: Optional[str] = None) -> str:
    return os.path.join(ledger_dir or default_ledger_dir(),
                        f"{check_job_id(job_id)}.ledger")


def list_jobs(ledger_dir: Optional[str] = None) -> list:
    try:
        names = os.listdir(ledger_dir or default_ledger_dir())
    except OSError:
        return []
    return sorted(n[:-len(".ledger")] for n in names
                  if n.endswith(".ledger"))


def task_digest(func: Callable, n_items: int, star: bool) -> str:
    """Weak identity of a map's task spec, stable across *processes*
    (a cloudpickle blob is not): the function's import path plus the
    item count and call shape. Guards job_id reuse against a different
    workload, not against same-named code edits — resumed tasks must be
    idempotent anyway (the resilient-pool contract)."""
    name = (getattr(func, "__module__", "?") or "?",
            getattr(func, "__qualname__",
                    getattr(func, "__name__", type(func).__name__)))
    spec = f"{name[0]}.{name[1]}|{int(n_items)}|{int(bool(star))}"
    return hashlib.sha256(spec.encode()).hexdigest()


def stream_task_digest(func: Callable, star: bool) -> str:
    """Stream-map task identity: like :func:`task_digest` but with NO
    item count — a stream's length is unknowable at submit time (the
    producer may not have run yet). Same guard scope: catches job_id
    reuse across different workloads, not same-named code edits."""
    name = (getattr(func, "__module__", "?") or "?",
            getattr(func, "__qualname__",
                    getattr(func, "__name__", type(func).__name__)))
    spec = f"{name[0]}.{name[1]}|stream|{int(bool(star))}"
    return hashlib.sha256(spec.encode()).hexdigest()


def load(path: str) -> Tuple[Dict[str, Any], Dict[int, Tuple[int, str]],
                             bool]:
    """Read one ledger: ``(header, completed, done)`` where completed
    maps ``base -> (n_items, payload_digest)``. A torn tail line (the
    crash landed mid-append) is skipped, never fatal; duplicate chunk
    records (speculation / resumed runs) keep the first occurrence.
    Stream ledgers (``kind="stream"`` headers) load too — callers
    branch on ``header["kind"]`` and use :func:`load_stream` for the
    admit/cursor records."""
    header: Dict[str, Any] = {}
    completed: Dict[int, Tuple[int, str]] = {}
    done = False
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                # Only the tail can be torn in an append-only file; a
                # mid-file parse failure would mean corruption, but the
                # safe degradation is identical: treat the rest as
                # unjournaled and re-execute it.
                logger.warning("ledger %s: skipping torn/corrupt record",
                               path)
                continue
            kind = rec.get("kind")
            if kind in ("map", "stream"):
                if int(rec.get("v", 0)) > LEDGER_VERSION:
                    raise ValueError(
                        f"ledger {path} is version {rec.get('v')}; this "
                        f"build reads <= {LEDGER_VERSION}")
                header = rec
            elif kind == "chunk":
                base = int(rec["base"])
                if base not in completed:
                    completed[base] = (int(rec["n"]), str(rec["digest"]))
            elif kind == "done":
                done = True
    if not header:
        raise ValueError(f"ledger {path} has no map header")
    return header, completed, done


def load_stream(path: str) -> Tuple[Dict[str, Any],
                                    Dict[int, Tuple[int, str]],
                                    Dict[int, Tuple[int, str]],
                                    int, bool]:
    """Read one STREAM ledger: ``(header, admits, completed, cursor,
    done)``. ``admits`` maps ``base -> (n, input_payload_digest)`` —
    the journaled input chunks, re-executable without the (dead)
    producer; ``completed`` maps ``base -> (n, result_digest)``;
    ``cursor`` is the LAST journaled consumer position (last-wins, not
    max: a fresh consumer restarting from zero must supersede the old
    run's high-water mark). The writer queue is FIFO, so journaled
    admits always form a contiguous prefix of admission order and
    ``completed``'s keys are a subset of ``admits``'s."""
    header: Dict[str, Any] = {}
    admits: Dict[int, Tuple[int, str]] = {}
    completed: Dict[int, Tuple[int, str]] = {}
    cursor = 0
    done = False
    with open(path, "r") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                logger.warning("ledger %s: skipping torn/corrupt record",
                               path)
                continue
            kind = rec.get("kind")
            if kind == "stream":
                if int(rec.get("v", 0)) > LEDGER_VERSION:
                    raise ValueError(
                        f"ledger {path} is version {rec.get('v')}; this "
                        f"build reads <= {LEDGER_VERSION}")
                header = rec
            elif kind == "admit":
                base = int(rec["base"])
                if base not in admits:
                    admits[base] = (int(rec["n"]), str(rec["digest"]))
            elif kind == "chunk":
                base = int(rec["base"])
                if base not in completed:
                    completed[base] = (int(rec["n"]), str(rec["digest"]))
            elif kind == "cursor":
                cursor = int(rec["consumed"])
            elif kind == "done":
                done = True
    if not header:
        raise ValueError(f"ledger {path} has no stream header")
    return header, admits, completed, cursor, done


class MapLedger:
    """Writer side of one job's ledger.

    ``record_chunk`` is the hot-loop entry: one lock round + list append;
    a daemon writer thread persists the payload into ``store`` (disk
    tier, so it survives the process) and appends the record, batching
    file ``fsync``\\ s per drain. ``on_chunk(digest)`` fires after each
    record is durable (the replication hook registers precious digests
    through it)."""

    def __init__(self, path: str, store,
                 fsync_interval: float = 0.05,
                 on_chunk: Optional[Callable[[str], None]] = None) -> None:
        self.path = path
        self._store = store
        self._interval = max(0.0, float(fsync_interval))
        self._on_chunk = on_chunk
        os.makedirs(os.path.dirname(path), exist_ok=True)
        # A crash mid-append leaves a torn final line WITHOUT a newline;
        # appending straight after it would weld the next record onto
        # the garbage and lose both. Terminate it first — load() then
        # skips exactly one unparseable line.
        torn = False
        try:
            with open(path, "rb") as fh:
                fh.seek(-1, os.SEEK_END)
                torn = fh.read(1) != b"\n"
        except (OSError, ValueError):
            pass  # missing or empty file: nothing to terminate
        self._fh = open(path, "a")
        if torn:
            self._fh.write("\n")
        self._cond = threading.Condition()
        self._queue: list = []
        self._pending = 0        # queued + in-write records
        self._closed = False
        #: base -> (n, digest) of every durably journaled chunk,
        #: including records adopted from a prior (crashed) run.
        self.journaled: Dict[int, Tuple[int, str]] = {}
        #: base -> (n, digest) of every journaled stream ADMIT (input
        #: chunk payloads; empty for classic whole-map ledgers).
        self.admitted: Dict[int, Tuple[int, str]] = {}
        self.digests: set = set()
        self.chunks_journaled = 0
        #: Disk bytes this ledger cost: journal lines (header, chunk,
        #: done records) plus the serialized result payloads persisted
        #: into the store's disk tier — the accounting plane's
        #: ``ledger_bytes`` axis (docs/observability.md).
        self.bytes_written = 0
        self._thread = threading.Thread(
            target=self._writer_loop, name="fiber-torch-map-ledger", daemon=True)
        self._thread.start()

    # -- hot-loop side ---------------------------------------------------
    def adopt(self, completed: Dict[int, Tuple[int, str]]) -> None:
        """Seed the dedup table from a loaded ledger (resume path): the
        prior run's chunks are already journaled and must not be
        re-appended when their restored fills echo through."""
        with self._cond:
            self.journaled.update(completed)
            self.digests.update(d for _, d in completed.values())
            self.chunks_journaled = len(self.journaled)

    def has(self, base: int) -> bool:
        with self._cond:
            return base in self.journaled

    # -- stream-ledger records (docs/streaming.md) -----------------------
    def adopt_admits(self, admits: Dict[int, Tuple[int, str]]) -> None:
        """Seed the admit dedup table on stream resume: the prior run's
        admitted input chunks are durable already and must not
        re-journal when the resumed producer re-admits them."""
        with self._cond:
            self.admitted.update(admits)
            self.digests.update(d for _, d in admits.values())

    def record_admit(self, base: int, n: int, items) -> bool:
        """Queue one admitted input chunk (the stream-ledger
        write-ahead leg): the writer persists the chunk's ITEMS into
        the store's disk tier and appends an ``admit`` record, so
        ``fiber-tpu resume`` can re-execute the chunk after a master
        crash without the (gone) producer iterator. Same hot-loop cost
        contract as record_chunk."""
        with self._cond:
            if self._closed or base in self.admitted:
                return False
            self.admitted[base] = (int(n), "")
            self._queue.append(("admit", base, int(n), items))
            self._pending += 1
            self._cond.notify_all()
        return True

    def record_cursor(self, consumed: int) -> bool:
        """Queue the consumer's position (count of results yielded, in
        order). Safe after close — the consumer may still be draining
        yielded results when the map's completion callbacks close the
        ledger; a dropped cursor only costs re-emitting a few consumed
        results on resume, never correctness. Pending cursor records
        coalesce: only the newest position is worth an fsync."""
        with self._cond:
            if self._closed:
                return False
            for i, rec in enumerate(self._queue):
                if rec[0] == "cursor":
                    self._queue[i] = ("cursor", int(consumed))
                    return True
            self._queue.append(("cursor", int(consumed)))
            self._pending += 1
            self._cond.notify_all()
        return True

    def record_chunk(self, base: int, n: int, values) -> bool:
        """Queue one completed chunk's result values for journaling —
        the writer thread serializes, persists the payload into the
        store's disk tier and appends the record, so the caller pays
        one lock round + list append. Returns False when the chunk is
        already journaled (speculative duplicates, resumed re-fills) or
        the ledger is closed."""
        with self._cond:
            if self._closed or base in self.journaled:
                return False
            # Reserve the base immediately: a duplicate result arriving
            # before the writer drains must not journal twice.
            self.journaled[base] = (int(n), "")
            self._queue.append(("chunk", base, int(n), values))
            self._pending += 1
            self._cond.notify_all()
        return True

    def record_done(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._queue.append(("done",))
            self._pending += 1
            self._cond.notify_all()

    def write_header(self, header: Dict[str, Any]) -> None:
        """Append + fsync the map header synchronously: the write-ahead
        contract — no chunk may dispatch before the header is durable."""
        rec = dict(header)
        rec.setdefault("kind", "map")
        rec.setdefault("v", LEDGER_VERSION)
        with self._cond:
            line = json.dumps(rec) + "\n"
            self._fh.write(line)
            self.bytes_written += len(line)
            self._fh.flush()
            os.fsync(self._fh.fileno())
        FLIGHT.record("store", "ledger", job=rec.get("job_id"),
                      event="header", n_items=rec.get("n_items"))

    def flush(self, timeout: float = 30.0) -> bool:
        """Block until everything queued so far is durable (fsync'd)."""
        with self._cond:
            return self._cond.wait_for(lambda: self._pending == 0,
                                       timeout)

    def close(self) -> None:
        with self._cond:
            if self._closed:
                return
            self._closed = True
            self._cond.notify_all()
        self._thread.join(10.0)
        with self._cond:
            try:
                self._fh.close()
            except OSError:
                pass

    # -- writer thread ---------------------------------------------------
    def _writer_loop(self) -> None:
        import time

        from fiber_tpu_torch.testing import chaos

        while True:
            with self._cond:
                self._cond.wait_for(
                    lambda: self._queue or self._closed)
                if not self._queue and self._closed:
                    return
                closing = self._closed
            if self._interval and not closing:
                # Accumulation window BEFORE the drain: a burst of chunk
                # completions lands in one write + one fsync instead of
                # paying the disk round trip per record.
                time.sleep(self._interval)
            with self._cond:
                batch, self._queue = self._queue, []
            wrote = 0
            for rec in batch:
                try:
                    line = self._durable_record(rec)
                except Exception:  # noqa: BLE001 - durability best-effort
                    # An unjournaled chunk degrades to re-execution on
                    # resume (tasks are idempotent); it must never take
                    # the pool down.
                    logger.warning("ledger %s: record failed; chunk will "
                                   "re-execute on resume", self.path,
                                   exc_info=True)
                    line = None
                if line is None:
                    continue
                with self._cond:
                    self._fh.write(line + "\n")
                    self.bytes_written += len(line) + 1
                wrote += 1
            with self._cond:
                if wrote:
                    try:
                        self._fh.flush()
                        os.fsync(self._fh.fileno())
                    except OSError:
                        logger.warning("ledger %s: fsync failed",
                                       self.path, exc_info=True)
                self._pending -= len(batch)
                self._cond.notify_all()
            if wrote:
                FLIGHT.record("store", "ledger",
                              path=os.path.basename(self.path),
                              event="append", records=wrote)
            # Post-fsync chaos hook: `kill_master_after_chunks` models a
            # master SIGKILL with exactly-N-journaled-chunks semantics
            # (the records above are durable when it fires).
            plan = chaos._plan
            if plan is not None:
                plan.maybe_kill_master(self.chunks_journaled)

    def _durable_record(self, rec) -> Optional[str]:
        if rec[0] == "done":
            return json.dumps({"kind": "done"})
        if rec[0] == "cursor":
            return json.dumps({"kind": "cursor", "consumed": rec[1]})
        if rec[0] == "admit":
            _, base, n, items = rec
            payload = serialization.dumps(items)
            digest = digest_of(payload)
            # Payload first, record second — same orphan-over-dangling
            # rule as result chunks.
            self._store.put_bytes(payload, refs=1, persist=True,
                                  digest=digest)
            with self._cond:
                self.admitted[base] = (n, digest)
                self.digests.add(digest)
                self.bytes_written += len(payload)
            if self._on_chunk is not None:
                try:  # admits are precious too: resume needs them
                    self._on_chunk(digest)
                except Exception:  # noqa: BLE001 - hook is observational
                    pass
            return json.dumps({"kind": "admit", "base": base, "n": n,
                               "digest": digest})
        _, base, n, values = rec
        payload = serialization.dumps(values)
        digest = digest_of(payload)
        # Payload first, record second: a crash between the two leaves
        # an orphan object (harmless), never a record pointing at
        # nothing.
        self._store.put_bytes(payload, refs=1, persist=True,
                              digest=digest)
        with self._cond:
            self.journaled[base] = (n, digest)
            self.digests.add(digest)
            self.chunks_journaled += 1
            self.bytes_written += len(payload)
        if self._on_chunk is not None:
            try:
                self._on_chunk(digest)
            except Exception:  # noqa: BLE001 - hook is observational
                pass
        return json.dumps({"kind": "chunk", "base": base, "n": n,
                           "digest": digest})
