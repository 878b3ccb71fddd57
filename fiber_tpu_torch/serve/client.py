"""Thin serve client (docs/serving.md "Client").

AgentClient-shaped: one lazily dialed authenticated connection, ops
serialized under a lock, the connection dropped (and re-dialed next
call) on any transport error — so a client process can outlive daemon
restarts, and a NEW client can poll a job some dead client submitted
(job state lives in the daemon + ledger, never in the submitting
connection).
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional, Tuple

from fiber_tpu_torch import serialization
from fiber_tpu_torch.serve import protocol
from fiber_tpu_torch.serve.daemon import DEFAULT_SERVE_PORT
from fiber_tpu_torch.utils.wire import Client


class ServeError(RuntimeError):
    """The daemon answered ``(False, repr(exc))`` — admission denial,
    unknown job, malformed request."""


def _dumps_func(func) -> bytes:
    """Cloudpickle BY VALUE when available (a ``__main__``-defined
    function must deserialize in the daemon, a different __main__),
    falling back to the plain serializer — the same posture as the
    ledger's spec payload."""
    try:
        import cloudpickle as _cp

        return _cp.dumps(func)
    except Exception:  # noqa: BLE001 - no cloudpickle / exotic fn
        return serialization.dumps(func)


class ServeClient:
    def __init__(self, address: Optional[Tuple[str, int]] = None,
                 authkey: Optional[bytes] = None) -> None:
        from fiber_tpu_torch import config as _config
        from fiber_tpu_torch.host_agent import cluster_authkey

        if address is None:
            address = ("127.0.0.1",
                       int(_config.get().serve_port)
                       or DEFAULT_SERVE_PORT)
        self._address = address
        self._authkey = authkey or cluster_authkey()
        self._conn = None
        self._lock = threading.Lock()

    # -- transport ------------------------------------------------------
    def _call(self, op: str, **payload: Any) -> Any:
        req = protocol.request(op, **payload)
        with self._lock:
            if self._conn is None:
                self._conn = Client(self._address,
                                    authkey=self._authkey)
            try:
                self._conn.send(req)
                ok, result = self._conn.recv()
            except (OSError, EOFError):
                # Dead daemon / dropped conn: redial once — a restarted
                # daemon is the same logical service.
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = Client(self._address,
                                    authkey=self._authkey)
                self._conn.send(req)
                ok, result = self._conn.recv()
        if not ok:
            raise ServeError(str(result))
        return result

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- verbs ----------------------------------------------------------
    def ping(self) -> str:
        return self._call("ping")

    def status(self) -> Dict[str, Any]:
        return self._call("status")

    def submit(self, func, items, tenant: str = "default",
               job_id: Optional[str] = None, star: bool = False,
               chunksize: Optional[int] = None,
               budget: Optional[Dict[str, Any]] = None,
               priority: float = 1.0) -> str:
        """Submit one job; returns its job_id (generated when not
        given). ``budget`` is a CostBudget field dict, e.g.
        ``{"tasks": 100, "cpu_s": 5.0}``."""
        protocol.check_tenant(tenant)
        if job_id is None:
            job_id = f"{tenant}-{uuid.uuid4().hex[:12]}"
        self._call("submit", tenant=tenant, job_id=job_id,
                   func=_dumps_func(func), items=list(items),
                   star=bool(star), chunksize=chunksize, budget=budget,
                   priority=float(priority))
        return job_id

    def poll(self, job_id: str) -> Dict[str, Any]:
        return self._call("poll", job_id=job_id)

    def wait(self, job_id: str, timeout: Optional[float] = None,
             interval: float = 0.1) -> Dict[str, Any]:
        """Poll until the job reaches a terminal state (or timeout —
        then the latest non-terminal view is returned)."""
        import time

        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            view = self.poll(job_id)
            if view.get("state") in protocol.TERMINAL_STATES:
                return view
            if deadline is not None and time.monotonic() >= deadline:
                return view
            time.sleep(interval)

    def results(self, job_id: str) -> List[Any]:
        return serialization.loads(self._call("results", job_id=job_id))

    def cancel(self, job_id: str) -> Dict[str, Any]:
        return self._call("cancel", job_id=job_id)

    def jobs(self, tenant: Optional[str] = None) -> List[Dict[str, Any]]:
        return self._call("jobs", tenant=tenant)

    def query(self, metric: str, since: Optional[float] = None,
              until: Optional[float] = None,
              labels: Optional[Dict[str, Any]] = None,
              limit: int = 1000) -> List[Dict[str, Any]]:
        """Archive time-range query: records of ``metric`` (a kind like
        ``"event"``/``"slo_obs"`` or a sample field like
        ``"tasks_per_s"``) in ``[since, until]`` epoch seconds, oldest
        first (docs/observability.md "SLOs and the archive")."""
        return self._call("query", metric=metric, since=since,
                          until=until, labels=labels, limit=limit)

    def slo(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Per-tenant SLI/SLO snapshot (targets, histograms, burn
        rates, breach state)."""
        return self._call("slo", tenant=tenant)

    def shutdown(self) -> str:
        return self._call("shutdown")
