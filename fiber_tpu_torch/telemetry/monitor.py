"""Anomaly watchdog: automatic detection of the failure modes the
chaos harness injects (docs/observability.md "Anomaly rules").

The watchdog rides the monitor sampler (:mod:`.timeseries`): every
``monitor_interval_s`` tick it receives the derived sample and checks a
small fixed rule set. A breach is an **edge event** — it fires once
when the rule newly trips (flight-recorder event on the new
``monitor`` plane, a log warning, and the ``monitor_anomalies``
counter) and clears when the signal recovers, so a long incident
doesn't spam one warning per tick. ``fiber-tpu top`` renders the
active set per host; ``snapshot()`` ships it through the agent's
``monitor_snapshot`` op.

Rules (knobs in config.py, docs/observability.md):

==================  ====================================================
throughput_drop     tasks/s fell more than ``anomaly_drop_pct`` below
                    the trailing-window mean while work is in flight —
                    the signature of a stuck/slowed worker
                    (chaos ``slow_worker_*``)
queue_growth        dispatch queue depth grew monotonically for
                    ``anomaly_queue_intervals`` consecutive samples —
                    submission outrunning the fleet
heartbeat_age       a peer has been silent longer than
                    ``suspect_timeout / 2`` — trouble brewing *before*
                    the failure detector declares (chaos
                    ``partition_*``)
store_disk_fill     the object store's disk tier is past
                    ``anomaly_disk_fill_pct`` of its bound — spill is
                    about to start failing
tx_queue_high       egress bytes queued in the transport exceed
                    ``anomaly_tx_queue_mb`` — a peer is not draining
budget_exceeded     a running map crossed its ``CostBudget`` caps
                    (accounting plane; raised via
                    :meth:`AnomalyWatchdog.external_breach` at charge
                    time, not on the sampler tick)
slo_burn            a serve-tier tenant's SLO is burning its error
                    budget past ``serve_slo_burn`` in BOTH burn
                    windows (SLO plane, telemetry/slo.py; raised via
                    :meth:`AnomalyWatchdog.external_breach` from the
                    daemon tick)
==================  ====================================================
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Deque, Dict, List, Optional

from fiber_tpu_torch import telemetry
from fiber_tpu_torch.telemetry.flightrec import FLIGHT
from fiber_tpu_torch.telemetry.policy import POLICY
from fiber_tpu_torch.utils.logging import get_logger

logger = get_logger()

_m_anomalies = telemetry.counter(
    "monitor_anomalies", "Watchdog rule breaches, by rule")

#: Trailing-window length (samples) for the throughput baseline.
TREND_WINDOW = 5

#: Recent anomaly records kept for the operator surface.
MAX_RECENT = 256


class AnomalyWatchdog:
    """Rule evaluation over monitor samples; see module docstring."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # knobs (refreshed from config via configure())
        self.drop_pct = 0.5
        self.queue_intervals = 5
        self.tx_queue_bytes = 16 << 20
        self.disk_fill_pct = 0.9
        self.suspect_timeout = 10.0
        self.hbm_fill_pct = 0.92
        # state
        self._rates: Deque[float] = collections.deque(
            maxlen=TREND_WINDOW + 1)
        self._queue_depths: Deque[float] = collections.deque(maxlen=64)
        self._active: Dict[str, Dict[str, Any]] = {}
        self._recent: Deque[Dict[str, Any]] = collections.deque(
            maxlen=MAX_RECENT)
        self.total = 0  # lifetime breaches

    def configure(self, cfg) -> None:
        """Re-read the anomaly knobs (telemetry.refresh)."""
        self.drop_pct = min(0.99, max(0.01, float(cfg.anomaly_drop_pct)))
        self.queue_intervals = max(2, int(cfg.anomaly_queue_intervals))
        self.tx_queue_bytes = int(float(cfg.anomaly_tx_queue_mb) * (1 << 20))
        self.disk_fill_pct = min(1.0, max(0.05,
                                          float(cfg.anomaly_disk_fill_pct)))
        self.suspect_timeout = float(cfg.suspect_timeout or 0.0)
        self.hbm_fill_pct = min(1.0, max(0.05,
                                         float(cfg.anomaly_hbm_fill_pct)))

    # -- breach bookkeeping --------------------------------------------
    def _raise_anomaly(self, rule: str, detail: str,
                       **attrs: Any) -> None:
        record = {
            "rule": rule, "detail": detail,
            "wall": time.time(), "mono": time.monotonic(),
        }
        record.update(attrs)
        # The anomaly's flight-event id is the cause_id every linked
        # policy/outcome event carries (the explain chain's join key).
        record["id"] = FLIGHT.record("monitor", rule, detail=detail,
                                     **attrs)
        self._active[rule] = record
        self._recent.append(record)
        self.total += 1
        _m_anomalies.inc(rule=rule)
        logger.warning("monitor: anomaly %s — %s", rule, detail)
        # Policy plane (telemetry/policy.py): the breach edge is the
        # remediation trigger. Called under self._lock — same posture
        # as the old hardwired device-tier arm; the engine must never
        # call back into this watchdog.
        try:
            POLICY.on_anomaly(self, rule, record)
        except Exception:  # noqa: BLE001 - policy must not break detection
            logger.exception("monitor: policy hook failed for %s", rule)

    def _clear_anomaly(self, rule: str) -> None:
        record = self._active.pop(rule, None)
        if record is not None:
            FLIGHT.record("monitor", "clear", rule=rule,
                          cause_id=record.get("id"))
            logger.info("monitor: anomaly %s cleared", rule)
            # Clear edge reverts the rule's applied remediation
            # (promote the tier, restore weights/high-water/...).
            try:
                POLICY.on_clear(self, rule, record)
            except Exception:  # noqa: BLE001 - policy must not break
                # detection
                logger.exception(
                    "monitor: policy clear hook failed for %s", rule)

    def _edge(self, rule: str, breached: bool, detail: str = "",
              **attrs: Any) -> None:
        if breached and rule not in self._active:
            self._raise_anomaly(rule, detail, **attrs)
        elif breached:
            # Still breached: refresh the standing record's severity
            # attrs in place (no new event — breaches stay edges). The
            # policy engine's outcome verification compares these
            # against their action-time values (resolved / persisted /
            # worsened).
            self._active[rule].update(attrs, detail=detail)
        elif not breached and rule in self._active:
            self._clear_anomaly(rule)

    # -- the sampler callback ------------------------------------------
    def observe(self, sample: Dict[str, Any]) -> None:
        with self._lock:
            self._observe_locked(sample)
        # Outcome verification rides the same tick, AFTER the lock
        # drops: the engine re-samples rule state through this
        # watchdog's lock (telemetry/policy.py).
        try:
            POLICY.poll()
        except Exception:  # noqa: BLE001 - policy must not break detection
            logger.exception("monitor: policy verification failed")

    def _observe_locked(self, sample: Dict[str, Any]) -> None:
        # 1. throughput collapse vs the trailing window
        rate = float(sample.get("tasks_per_s") or 0.0)
        inflight = float(sample.get("inflight") or 0.0)
        trailing = list(self._rates)
        self._rates.append(rate)
        baseline = (sum(trailing) / len(trailing)) if trailing else 0.0
        breached = (
            len(trailing) >= TREND_WINDOW
            and baseline > 0.0
            and inflight > 0.0
            and rate < (1.0 - self.drop_pct) * baseline
        )
        self._edge(
            "throughput_drop", breached,
            detail=(f"tasks/s {rate:.1f} < "
                    f"{(1.0 - self.drop_pct):.2f}x trailing "
                    f"{baseline:.1f} with {inflight:.0f} in flight"),
            rate=round(rate, 3), baseline=round(baseline, 3))
        if breached:
            # A collapsed rate must not drag the baseline down to the
            # collapse level (which would self-clear the anomaly while
            # the worker is still stuck): freeze the window.
            self._rates.pop()

        # 2. queue depth monotonically growing
        depth = float(sample.get("queue_depth") or 0.0)
        self._queue_depths.append(depth)
        n = self.queue_intervals
        window = list(self._queue_depths)[-(n + 1):]
        growing = (
            len(window) >= n + 1
            and all(b > a for a, b in zip(window, window[1:]))
        )
        self._edge(
            "queue_growth", growing,
            detail=(f"dispatch queue grew {window[0]:.0f} -> "
                    f"{window[-1]:.0f} over {n} intervals"),
            depth=depth)

        # 3. heartbeat age past half the suspect deadline
        age = float(sample.get("heartbeat_age_s") or 0.0)
        threshold = self.suspect_timeout / 2.0
        self._edge(
            "heartbeat_age",
            self.suspect_timeout > 0 and age > threshold,
            detail=(f"oldest peer silence {age:.2f}s > "
                    f"suspect_timeout/2 ({threshold:.2f}s)"),
            age_s=round(age, 3))

        # 4. store disk-tier fill (only when a store exists — probing
        # must not instantiate one)
        usage, bound = _store_disk_usage()
        self._edge(
            "store_disk_fill",
            bound > 0 and usage > self.disk_fill_pct * bound,
            detail=(f"store disk tier {usage >> 20}MB > "
                    f"{self.disk_fill_pct:.0%} of {bound >> 20}MB"),
            bytes=usage)

        # 5. transport egress queue high water
        txq = float(sample.get("tx_queue_bytes") or 0.0)
        self._edge(
            "tx_queue_high", txq > self.tx_queue_bytes,
            detail=(f"tx queue {int(txq) >> 20}MB > "
                    f"{self.tx_queue_bytes >> 20}MB — a peer is not "
                    "draining"),
            bytes=int(txq))

        # 6. HBM fill (device telemetry plane; both fields None on CPU
        # or when no device runtime exists — honest null, no breach).
        # This rule REMEDIATES, not just observes: the policy engine's
        # hbm_fill policy (telemetry/policy.py, the refactored PR-13
        # arm) demotes the device store tier on the breach edge and
        # re-promotes on the clear edge — closed loop, flight-evented
        # by the tier itself plus the engine's policy/outcome chain.
        used, limit = _hbm_usage()
        self._edge(
            "hbm_fill", limit > 0 and used > self.hbm_fill_pct * limit,
            detail=(f"HBM {used >> 20}MB > "
                    f"{self.hbm_fill_pct:.0%} of {limit >> 20}MB"),
            bytes=used, limit=limit)

        # 7. recompile storm: one fingerprint compiling repeatedly
        # inside the device plane's window — shape churn, not progress
        storm = _recompile_state()
        self._edge(
            "recompile_storm", bool(storm.get("storm")),
            detail=(f"{storm.get('count', 0)} recompiles of "
                    f"{str(storm.get('fingerprint'))[:48]!r} within "
                    f"{storm.get('window_s', 0)}s"),
            fingerprint=str(storm.get("fingerprint"))[:48],
            count=int(storm.get("count", 0)))

    # -- external rules -------------------------------------------------
    def external_breach(self, rule: str, detail: str,
                        **attrs: Any) -> None:
        """Raise a rule owned by another plane (edge-triggered like the
        sampler rules; re-raising an active rule only refreshes its
        record). The accounting plane's ``budget_exceeded`` rides this:
        budgets are checked at charge time, not on the sampler tick
        (docs/observability.md "Resource accounting")."""
        with self._lock:
            if rule in self._active:
                self._active[rule].update(attrs, detail=detail)
                return
            self._raise_anomaly(rule, detail, **attrs)

    def external_clear(self, rule: str) -> None:
        with self._lock:
            self._clear_anomaly(rule)

    # -- read side -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "active": {r: dict(rec)
                           for r, rec in self._active.items()},
                "recent": [dict(r) for r in self._recent],
                "total": self.total,
            }

    def clear(self) -> None:
        with self._lock:
            self._active.clear()
            self._recent.clear()
            self._rates.clear()
            self._queue_depths.clear()
            self.total = 0


def _hbm_usage() -> "tuple[int, int]":
    """(bytes in use, limit) of the first local device's HBM; (0, 0)
    when unavailable (CPU, no device runtime) — the rule can't breach
    without a real limit."""
    try:
        from fiber_tpu_torch.telemetry.device import DEVICE

        with DEVICE._lock:
            hbm = dict(DEVICE._hbm)
        return int(hbm.get("bytes_in_use") or 0), \
            int(hbm.get("bytes_limit") or 0)
    except Exception:  # noqa: BLE001 - monitoring must not fail
        return 0, 0


def _recompile_state() -> Dict[str, Any]:
    """The device plane's recompile-storm probe (monkeypatchable in
    tests, like _store_disk_usage)."""
    try:
        from fiber_tpu_torch.telemetry.device import DEVICE

        return DEVICE.recompile_state()
    except Exception:  # noqa: BLE001 - monitoring must not fail
        return {"storm": False}


def _store_disk_usage() -> "tuple[int, int]":
    """(bytes used, bound) of the process store's disk tier; (0, 0)
    when no store has been built or it has no disk root."""
    try:
        from fiber_tpu_torch import store as storemod

        st = storemod._store  # peek, never instantiate
        if st is None or st.root is None:
            return 0, 0
        return st.disk_usage(), int(st.max_disk_bytes)
    except Exception:  # noqa: BLE001 - monitoring must not fail
        return 0, 0


#: Process-wide watchdog; registered as a TIMESERIES observer by
#: telemetry.refresh().
WATCHDOG = AnomalyWatchdog()


def monitor_payload(history: int = 120) -> Dict[str, Any]:
    """The per-host monitor surface: latest derived sample + bounded
    ring history + the watchdog state + per-peer heartbeat ages. One
    shape shared by the host agent's ``monitor_snapshot`` op, the
    local backend's ``cluster_timeseries`` and ``Pool.timeseries()``
    so `fiber-tpu top` renders any source identically."""
    import os as _os

    from fiber_tpu_torch import health
    from fiber_tpu_torch.telemetry import tracing
    from fiber_tpu_torch.telemetry.timeseries import TIMESERIES

    try:
        ages = {str(k): round(v, 3)
                for k, v in health.heartbeat_ages().items()}
    except Exception:  # noqa: BLE001
        ages = {}
    try:
        actions = POLICY.recent_actions(8)
    except Exception:  # noqa: BLE001
        actions = []
    return {
        "host": tracing.host_id(),
        "pid": _os.getpid(),
        "timeseries": TIMESERIES.snapshot(last=int(history)),
        "anomalies": WATCHDOG.snapshot(),
        "heartbeat_ages": ages,
        "device": _device_summary(),
        # Autonomous operations: what this host's policy engine DID
        # about the anomalies above (`fiber-tpu top` action feed).
        "policy": actions,
    }


def _device_summary() -> Dict[str, Any]:
    """Compact device-plane row for `fiber-tpu top` (HBM + MFU
    columns): None fields are honest nulls, never zeros — the table
    renders them as '-' (docs/observability.md "Device telemetry").
    ``card_hbm`` is the card as NVML sees it, reported by a process
    without a CUDA context (a host agent) for the table alone."""
    try:
        from fiber_tpu_torch.telemetry.device import DEVICE

        snap = DEVICE.snapshot()
        out = {
            "hbm_bytes_in_use": snap["hbm"].get("bytes_in_use"),
            "hbm_bytes_limit": snap["hbm"].get("bytes_limit"),
            "card_hbm": snap.get("card_hbm"),
            "mfu": snap["mfu"].get("mfu"),
            "compiles": snap.get("compiles", 0),
            "transfer_bytes": snap.get("transfer_bytes", 0),
            # device store tier occupancy (None = no tier built here —
            # a host-plane process; 'top' renders it '-')
            "dev_store_bytes": None,
            "dev_store_demoted": None,
        }
        from fiber_tpu_torch import store as storemod

        tier = storemod._dtier  # peek, never instantiate
        if tier is not None:
            tstats = tier.stats()
            out["dev_store_bytes"] = int(tstats.get("bytes", 0))
            out["dev_store_demoted"] = bool(tstats.get("demoted"))
        return out
    except Exception:  # noqa: BLE001 - monitoring must not fail
        return {}
