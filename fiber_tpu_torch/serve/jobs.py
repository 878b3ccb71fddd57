"""JobRunner: the daemon-ownable job lifecycle refactored out of the
one-script-one-Pool model (docs/serving.md "Job lifecycle").

``Pool`` already knows how to run ONE process's maps; the serving tier
needs many tenants' jobs multiplexed onto ONE long-lived pool, each
with its own billing identity, durable ledger and independently
pollable verdict. JobRunner is that seam: it owns the shared
:class:`fiber_tpu_torch.Pool`, tracks every submitted job in a table, stamps
``tenant=`` / ``job_id=`` / ``budget=`` onto each ``map_async``, and
journals job metadata to ``<staging>/serve/<job_id>.json`` so a
restarted daemon knows WHAT was in flight — the ledger already
knows HOW FAR each job got, and :meth:`JobRunner.replay` re-submits
from the ledger's journaled spec payload exactly the way ``fiber-tpu
resume`` does, restoring completed chunks and re-executing only the
remainder (exactly-once, proven by the per-job cost record's
``tasks`` + ``tasks_restored`` split).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

from fiber_tpu_torch import serialization
from fiber_tpu_torch.serve import protocol
from fiber_tpu_torch.telemetry import accounting
from fiber_tpu_torch.telemetry.accounting import COSTS, CostBudget
from fiber_tpu_torch.utils.logging import get_logger

logger = get_logger()


def serve_dir(root: Optional[str] = None) -> str:
    """The serve-tier job journal directory (``serve_dir`` knob; ""
    puts it at ``<staging root>/serve``, beside ``ledger/`` and
    ``costs/``)."""
    from fiber_tpu_torch import config as _config
    from fiber_tpu_torch.host_agent import default_staging_root

    if root:
        return root
    cfg_dir = str(_config.get().serve_dir or "")
    return cfg_dir or os.path.join(default_staging_root(), "serve")


class Job:
    """One tracked job. Mutated only under the runner's lock; the
    ``view()`` dict is what crosses the wire."""

    __slots__ = ("tenant", "job_id", "state", "n_items", "star",
                 "chunksize", "submitted_at", "started_at",
                 "finished_at", "error", "results", "cancel_requested",
                 "replayed")

    def __init__(self, tenant: str, job_id: str, n_items: int,
                 star: bool, chunksize: Optional[int]) -> None:
        self.tenant = tenant
        self.job_id = job_id
        self.state = protocol.QUEUED
        self.n_items = n_items
        self.star = bool(star)
        self.chunksize = chunksize
        self.submitted_at = time.time()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.error: Optional[str] = None
        self.results: Optional[List[Any]] = None
        self.cancel_requested = False
        self.replayed = False

    def view(self) -> Dict[str, Any]:
        return {
            "tenant": self.tenant, "job_id": self.job_id,
            "state": self.state, "n_items": self.n_items,
            "submitted_at": self.submitted_at,
            "started_at": self.started_at,
            "finished_at": self.finished_at, "error": self.error,
            "replayed": self.replayed,
        }


class JobRunner:
    """Owns the shared pool + job table. Thread-safe: submissions come
    from per-connection RPC threads, verdicts from pool callback
    threads, escalations from the daemon's tick thread."""

    def __init__(self, processes: Optional[int] = None,
                 journal_dir: Optional[str] = None) -> None:
        self._processes = processes
        self._dir = serve_dir(journal_dir)
        os.makedirs(self._dir, exist_ok=True)
        self._lock = threading.RLock()
        self._jobs: Dict[str, Job] = {}
        self._pool = None
        self._closed = False

    # -- pool ----------------------------------------------------------
    @property
    def pool(self):
        """The shared pool, created on first use (so a daemon that
        starts with replayable jobs builds it during replay, and an
        idle one still answers status)."""
        with self._lock:
            if self._pool is None:
                if self._closed:
                    raise RuntimeError("JobRunner is closed")
                import fiber_tpu_torch

                self._pool = fiber_tpu_torch.Pool(self._processes)
            return self._pool

    # -- journal -------------------------------------------------------
    def _journal_path(self, job_id: str) -> str:
        return os.path.join(self._dir, f"{job_id}.json")

    def _journal(self, job: Job) -> None:
        """Persist one job's metadata (atomic rename — a torn record
        must never make a job unreplayable)."""
        path = self._journal_path(job.job_id)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as fh:
                json.dump(job.view(), fh)
            os.replace(tmp, path)
        except OSError:
            logger.warning("serve: journal write failed for job %r",
                           job.job_id, exc_info=True)

    # -- submission ----------------------------------------------------
    def submit(self, tenant: str, job_id: str, func: Any,
               items: List[Any], star: bool = False,
               chunksize: Optional[int] = None,
               budget: Optional[Dict[str, Any]] = None,
               priority: float = 1.0,
               replayed: bool = False) -> Dict[str, Any]:
        """Admit one job onto the shared pool. The caller (daemon) has
        already run admission control; this is pure dispatch +
        tracking. Raises on duplicate active job_id."""
        from fiber_tpu_torch.store import ledger as ledgermod

        protocol.check_tenant(tenant)
        ledgermod.check_job_id(job_id)
        cost_budget = CostBudget(**budget) if budget else None
        with self._lock:
            old = self._jobs.get(job_id)
            if old is not None and old.state in protocol.REPLAYABLE_STATES:
                raise ValueError(f"job {job_id!r} is already "
                                 f"{old.state}")
            job = Job(tenant, job_id, len(items), star, chunksize)
            job.replayed = replayed
            self._jobs[job_id] = job
        self._journal(job)

        def on_done(values: List[Any]) -> None:
            with self._lock:
                job.results = values
                job.state = protocol.DONE
                job.finished_at = time.time()
            self._journal(job)

        def on_error(exc: BaseException) -> None:
            from fiber_tpu_torch.pool import JobPreemptedError

            with self._lock:
                if isinstance(exc, JobPreemptedError):
                    job.state = (protocol.CANCELLED
                                 if job.cancel_requested
                                 else protocol.PREEMPTED)
                else:
                    job.state = protocol.FAILED
                job.error = repr(exc)
                job.finished_at = time.time()
            self._journal(job)

        pool = self.pool
        mapper = pool.starmap_async if star else pool.map_async
        try:
            mapper(func, items, chunksize=chunksize,
                   callback=on_done, error_callback=on_error,
                   priority=priority, job_id=job_id,
                   budget=cost_budget, tenant=tenant)
        except BaseException as exc:
            with self._lock:
                job.state = protocol.FAILED
                job.error = repr(exc)
                job.finished_at = time.time()
            self._journal(job)
            raise
        with self._lock:
            if job.state == protocol.QUEUED:
                job.state = protocol.RUNNING
                # Queue-wait SLI stamp (telemetry/slo.py): dispatch
                # admission is done, chunks are the scheduler's now.
                job.started_at = time.time()
        self._journal(job)
        return job.view()

    # -- read side -----------------------------------------------------
    def poll(self, job_id: str) -> Dict[str, Any]:
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None:
                return job.view()
        # Not in memory: a pre-restart job this daemon never replayed
        # (terminal states are not replayed). Serve the journal record.
        try:
            with open(self._journal_path(job_id)) as fh:
                return json.load(fh)
        except (OSError, ValueError):
            raise KeyError(f"unknown job {job_id!r}") from None

    def results(self, job_id: str):
        """Serialized results of a DONE job (bytes cross the wire
        as-is; the client deserializes). A done-before-restart job
        whose results left memory re-enters via replay()'s
        restore-everything path before this can answer."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(f"unknown job {job_id!r}")
            if job.state != protocol.DONE:
                raise ValueError(
                    f"job {job_id!r} is {job.state}, not done")
            return serialization.dumps(job.results)

    def jobs(self, tenant: Optional[str] = None) -> List[Dict[str, Any]]:
        """Every tracked job (journal-backed ones included), newest
        first, optionally filtered by tenant."""
        seen: Dict[str, Dict[str, Any]] = {}
        try:
            names = sorted(os.listdir(self._dir))
        except OSError:
            names = []
        for name in names:
            if not name.endswith(".json") or ".tmp." in name:
                continue
            try:
                with open(os.path.join(self._dir, name)) as fh:
                    rec = json.load(fh)
            except (OSError, ValueError):
                continue
            if isinstance(rec, dict) and rec.get("job_id"):
                seen[rec["job_id"]] = rec
        with self._lock:
            for job_id, job in self._jobs.items():
                seen[job_id] = job.view()
        out = [r for r in seen.values()
               if tenant is None or r.get("tenant") == tenant]
        out.sort(key=lambda r: r.get("submitted_at") or 0.0,
                 reverse=True)
        return out

    def terminal_views(self) -> List[Dict[str, Any]]:
        """Views of every in-memory job in a terminal state (the SLO
        plane's per-tick observation feed — memory only, no journal
        I/O; pre-restart jobs re-enter the SLIs via the archive replay
        instead)."""
        with self._lock:
            return [j.view() for j in self._jobs.values()
                    if j.state in protocol.TERMINAL_STATES]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for job in self._jobs.values():
                out[job.state] = out.get(job.state, 0) + 1
            return out

    def running_jobs(self, tenant: str) -> int:
        with self._lock:
            return sum(1 for j in self._jobs.values()
                       if j.tenant == tenant
                       and j.state in protocol.REPLAYABLE_STATES)

    # -- control -------------------------------------------------------
    def cancel(self, job_id: str) -> Dict[str, Any]:
        """Client cancel: preempt through the SAME path as budget
        enforcement — the ledger survives, so a cancelled job is
        resumable (resubmit with the same job_id)."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None:
                raise KeyError(f"unknown job {job_id!r}")
            if job.state in protocol.TERMINAL_STATES:
                return job.view()
            job.cancel_requested = True
        self.pool.preempt_job(job_id)
        return self.poll(job_id)

    def preempt_key(self, key) -> int:
        """Budget escalation (admission tick): preempt every map billed
        to one ``(tenant, job, map)`` key. The affected job's
        error_callback lands JobPreemptedError and parks it
        ``preempted``."""
        return self.pool.preempt_billing_key(key)

    # -- restart replay ------------------------------------------------
    def replay(self) -> List[str]:
        """Daemon restart: every journaled job still in a replayable
        state is re-submitted from its ledger's spec payload — the same
        reconstruction ``fiber-tpu resume`` runs — under its original
        tenant/job_id. Completed chunks restore from the ledger;
        exactly-once billing records them as ``tasks_restored``.
        Returns the replayed job ids."""
        from fiber_tpu_torch import store as storemod
        from fiber_tpu_torch.store import ledger as ledgermod

        replayed: List[str] = []
        for rec in self.jobs():
            if rec.get("state") not in protocol.REPLAYABLE_STATES:
                continue
            job_id = rec["job_id"]
            tenant = rec.get("tenant") or COSTS.tenant
            try:
                path = ledgermod.job_path(job_id)
                if not os.path.exists(path):
                    raise ValueError("no ledger on disk")
                header, _completed, done = ledgermod.load(path)
                spec_digest = header.get("spec")
                if not spec_digest:
                    raise ValueError("ledger has no spec payload")
                data = storemod.local_store().get_bytes(spec_digest)
                if data is None:
                    raise ValueError(
                        f"spec payload {spec_digest[:12]} lost")
                func_blob, items, star, chunksize = \
                    serialization.loads(data)
                func = serialization.loads(func_blob)
            except Exception as exc:  # noqa: BLE001 - per-job isolation
                logger.warning(
                    "serve: cannot replay job %r (%s); marking failed",
                    job_id, exc)
                job = Job(tenant, job_id, int(rec.get("n_items") or 0),
                          bool(rec.get("star")), None)
                job.state = protocol.FAILED
                job.error = f"replay failed: {exc}"
                job.finished_at = time.time()
                with self._lock:
                    self._jobs[job_id] = job
                self._journal(job)
                continue
            self.submit(tenant, job_id, func, items, star=star,
                        chunksize=chunksize, replayed=True)
            replayed.append(job_id)
            logger.info("serve: replayed job %r (tenant %s, %d tasks)",
                        job_id, tenant, len(items))
        return replayed

    # -- teardown ------------------------------------------------------
    def close(self, terminate: bool = False) -> None:
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, None
        if pool is not None:
            if terminate:
                pool.terminate()
            else:
                pool.close()
            pool.join()

    # -- accounting read side (fiber-tpu jobs --tenant) ---------------
    @staticmethod
    def job_tenant(job_id: str) -> Optional[str]:
        """Tenant label from the persisted per-job cost record (the
        accounting plane writes it beside the ledger)."""
        rec = accounting.read_job_record(job_id)
        if isinstance(rec, dict):
            return rec.get("tenant")
        return None
