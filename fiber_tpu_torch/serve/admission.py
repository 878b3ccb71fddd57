"""Admission control + budget escalation (docs/serving.md "Admission").

Two halves:

- :meth:`AdmissionController.check` runs at submit time and REFUSES a
  job before it touches the pool: standing watchdog anomalies from the
  deny list (``serve_deny_rules`` — e.g. a filling store disk or HBM),
  an open worker-spawn breaker (the cluster cannot start workers; a
  new job would only queue behind a broken backend), and per-tenant
  quotas (``serve_tenant_jobs`` / ``_tasks`` / ``_cpu_s``) enforced
  against the accounting plane's live ``(tenant, job, map)`` cost
  vectors.

- :meth:`AdmissionController.tick` runs on the daemon's housekeeping
  thread and ESCALATES standing ``budget_exceeded`` breaches: the
  policy plane's first response is the WDRR throttle — the
  offender keeps running at the scheduler's weight floor — and after
  ``serve_preempt_grace_s`` seconds still in breach, the serve tier
  preempts for real: journaled progress stays in the ledger, in-flight
  chunks are reclaimed through the existing release/resubmit path, and
  the job parks ``preempted`` + resumable. This closes the enforcement
  hook :mod:`fiber_tpu_torch.telemetry.accounting` deliberately left to the
  caller.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from fiber_tpu_torch.telemetry import accounting
from fiber_tpu_torch.telemetry.accounting import COSTS
from fiber_tpu_torch.utils.logging import get_logger

logger = get_logger()


class AdmissionError(Exception):
    """Submission refused; ``reason`` is machine-readable (the client
    surfaces it verbatim)."""

    def __init__(self, reason: str, detail: str) -> None:
        super().__init__(f"{reason}: {detail}")
        self.reason = reason
        self.detail = detail


class AdmissionController:
    """Stateless checks + a small breach-age table for escalation.
    One instance per daemon; ``runner`` is its :class:`JobRunner`."""

    def __init__(self, runner, deny_rules: Optional[List[str]] = None,
                 tenant_jobs: int = 0, tenant_tasks: int = 0,
                 tenant_cpu_s: float = 0.0,
                 preempt_grace_s: float = 2.0) -> None:
        self._runner = runner
        self._deny_rules = [r.strip() for r in (deny_rules or [])
                            if r.strip()]
        self._tenant_jobs = int(tenant_jobs)
        self._tenant_tasks = int(tenant_tasks)
        self._tenant_cpu_s = float(tenant_cpu_s)
        self._grace_s = float(preempt_grace_s)
        #: breached key -> first-seen monotonic time (escalation clock).
        self._breach_t0: Dict[str, float] = {}
        self._lock = threading.Lock()
        #: counters for status/top: reason -> denials.
        self.denied: Dict[str, int] = {}
        self.preempted: int = 0

    @classmethod
    def from_config(cls, runner, cfg) -> "AdmissionController":
        return cls(
            runner,
            deny_rules=str(cfg.serve_deny_rules or "").split(","),
            tenant_jobs=int(cfg.serve_tenant_jobs),
            tenant_tasks=int(cfg.serve_tenant_tasks),
            tenant_cpu_s=float(cfg.serve_tenant_cpu_s),
            preempt_grace_s=float(cfg.serve_preempt_grace_s),
        )

    # -- submit-time gate ----------------------------------------------
    def _deny(self, reason: str, detail: str) -> None:
        with self._lock:
            self.denied[reason] = self.denied.get(reason, 0) + 1
        logger.warning("serve: admission denied (%s): %s", reason,
                       detail)
        raise AdmissionError(reason, detail)

    def _tenant_usage(self, tenant: str) -> Dict[str, float]:
        """Cumulative cost over every live/retained key billed to the
        tenant (overhead excluded) — the quota denominator."""
        out: Dict[str, float] = {}
        snap = COSTS.snapshot()
        for kstr, vec in (snap.get("costs") or {}).items():
            key = accounting.parse_key(kstr)
            if key[0] != tenant or key[2] == "overhead":
                continue
            for field, n in vec.items():
                out[field] = out.get(field, 0.0) + float(n)
        return out

    def check(self, tenant: str, n_items: int) -> None:
        """Raise :class:`AdmissionError` if this submission must be
        refused; return silently to admit."""
        # 1. Standing watchdog anomalies on the deny list: the cluster
        # is visibly unhealthy in a way more load worsens.
        if self._deny_rules:
            from fiber_tpu_torch.telemetry.monitor import WATCHDOG

            active = WATCHDOG.snapshot().get("active") or {}
            for rule in self._deny_rules:
                rec = active.get(rule)
                if rec is not None:
                    self._deny(
                        "unhealthy",
                        f"standing {rule} anomaly: "
                        f"{rec.get('detail') or ''}")
        # 2. Worker-spawn breaker open: the backend refuses to start
        # workers; admitting queues work behind a broken substrate.
        pool = getattr(self._runner, "_pool", None)
        if pool is not None:
            try:
                breaker_state = pool._spawn_breaker.state(
                    pool._spawn_key)
            except Exception:  # noqa: BLE001 - health probe only
                breaker_state = "closed"
            if breaker_state == "open":
                self._deny("no_workers",
                           "worker-spawn breaker is open (backend "
                           "refusing starts)")
        # 3. Per-tenant quotas against live accounting vectors.
        if self._tenant_jobs > 0:
            running = self._runner.running_jobs(tenant)
            if running >= self._tenant_jobs:
                self._deny("quota_jobs",
                           f"tenant {tenant} has {running} running "
                           f"job(s), quota {self._tenant_jobs}")
        if self._tenant_tasks > 0 or self._tenant_cpu_s > 0:
            usage = self._tenant_usage(tenant)
            if self._tenant_tasks > 0 and \
                    usage.get("tasks", 0.0) + n_items > self._tenant_tasks:
                self._deny(
                    "quota_tasks",
                    f"tenant {tenant} at {usage.get('tasks', 0.0):.0f} "
                    f"tasks + {n_items} submitted > quota "
                    f"{self._tenant_tasks}")
            if self._tenant_cpu_s > 0 and \
                    usage.get("cpu_s", 0.0) > self._tenant_cpu_s:
                self._deny(
                    "quota_cpu",
                    f"tenant {tenant} at {usage.get('cpu_s', 0.0):.1f} "
                    f"cpu-seconds > quota {self._tenant_cpu_s}")

    # -- escalation tick ------------------------------------------------
    def tick(self) -> int:
        """Escalate budget breaches older than the grace period from
        throttling to preemption. Returns maps preempted this tick.

        The breach table is ``COSTS.snapshot()['breached']`` — per-key,
        unlike the single edge-triggered ``budget_exceeded`` watchdog
        record — so concurrent offenders escalate independently. A key
        that leaves the table (map completed, or preempted last tick)
        drops its clock."""
        breached = COSTS.snapshot().get("breached") or {}
        now = time.monotonic()
        ripe: List[str] = []
        with self._lock:
            for kstr in breached:
                t0 = self._breach_t0.setdefault(kstr, now)
                if now - t0 >= self._grace_s:
                    ripe.append(kstr)
            for kstr in list(self._breach_t0):
                if kstr not in breached:
                    del self._breach_t0[kstr]
        n = 0
        for kstr in ripe:
            key = accounting.parse_key(kstr)
            try:
                stopped = self._runner.preempt_key(key)
            except Exception:  # noqa: BLE001 - one key must not stop the rest
                logger.exception("serve: preemption failed for %s", kstr)
                continue
            if stopped:
                n += stopped
                with self._lock:
                    self.preempted += stopped
                    self._breach_t0.pop(kstr, None)
                logger.warning(
                    "serve: budget breach on %s outlived the %.1fs "
                    "throttle grace — preempted %d map(s); job parked "
                    "resumable", kstr, self._grace_s, stopped)
        return n

    def stats(self) -> Dict[str, object]:
        with self._lock:
            return {"denied": dict(self.denied),
                    "preempted_maps": self.preempted,
                    "watching_breaches": len(self._breach_t0)}
