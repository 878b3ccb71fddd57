"""Warm worker pool: elastic standby capacity (docs/serving.md
"Warm pool").

A newly admitted tenant must not pay worker cold-spawn latency (~1s of
interpreter boot + handshake per worker) on its first chunk. The warm
pool keeps ``serve_warm_floor`` workers spawned even when the daemon
is idle, scales the shared pool up toward ``serve_warm_ceiling`` when
the scheduler's load (in-flight + queued chunks — the same numbers the
``sched_host_inflight_chunks`` gauge exports) outruns current
capacity, and scales back down to the floor after ``serve_warm_idle_s``
seconds of zero load. Scaling goes through
:meth:`fiber_tpu_torch.pool.Pool.resize`, so scale-down rides the pool's
normal worker-death reclaim path and can never lose work.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from fiber_tpu_torch.utils.logging import get_logger

logger = get_logger()


class WarmPool:
    """Periodic scaling decisions for one runner's shared pool; driven
    by the daemon's tick thread (no thread of its own)."""

    def __init__(self, runner, floor: int = 2, ceiling: int = 0,
                 idle_s: float = 5.0) -> None:
        self._runner = runner
        self.floor = max(1, int(floor))
        self.ceiling = max(self.floor, int(ceiling)) if ceiling else 0
        self.idle_s = float(idle_s)
        self._idle_since: Optional[float] = None
        self._lock = threading.Lock()
        self.scale_ups = 0
        self.scale_downs = 0
        # slo_burn boost state: the pre-boost floor, None when not
        # boosted (telemetry/policy.py's warm-pool lever).
        self._boost_floor: Optional[int] = None

    @classmethod
    def from_config(cls, runner, cfg) -> "WarmPool":
        return cls(runner,
                   floor=int(cfg.serve_warm_floor),
                   ceiling=int(cfg.serve_warm_ceiling),
                   idle_s=float(cfg.serve_warm_idle_s))

    def _ceiling(self, pool) -> int:
        if self.ceiling:
            return self.ceiling
        # 0 = the pool's configured size is the ceiling; captured at
        # prewarm time, before the first resize rewrites _n_workers.
        cap = getattr(self, "_config_ceiling", None)
        if cap is None:
            cap = self._config_ceiling = max(
                self.floor, int(getattr(pool, "_n_workers", 1)))
        return cap

    def prewarm(self) -> None:
        """Bring the pool to the floor NOW (daemon start): the first
        tenant's first chunk finds workers already handshaken."""
        pool = self._runner.pool
        self._ceiling(pool)  # pin the elastic range before resizing
        pool.resize(self.floor)

    def tick(self) -> None:
        """One scaling decision. Scale-up is immediate (demand is
        latency); scale-down waits out ``idle_s`` of sustained zero
        load (hysteresis — chunk gaps must not thrash workers)."""
        pool = self._runner._pool
        if pool is None or pool._closed or pool._terminated:
            return
        inflight, queued = pool._sched.load()
        demand = inflight + queued
        current = int(getattr(pool, "_n_workers", 1))
        ceiling = self._ceiling(pool)
        with self._lock:
            if demand > 0:
                self._idle_since = None
                desired = min(ceiling, max(self.floor, demand))
                if desired > current:
                    pool.resize(desired)
                    self.scale_ups += 1
                    logger.info(
                        "serve: warm pool scale-up %d -> %d workers "
                        "(%d in flight + %d queued)", current, desired,
                        inflight, queued)
                return
            now = time.monotonic()
            if self._idle_since is None:
                self._idle_since = now
                return
            if now - self._idle_since >= self.idle_s \
                    and current > self.floor:
                pool.resize(self.floor)
                self.scale_downs += 1
                self._idle_since = now
                logger.info(
                    "serve: warm pool idle %.1fs — scale-down %d -> %d "
                    "workers (floor)", self.idle_s, current, self.floor)

    # -- policy-plane levers (slo_burn; telemetry/policy.py) -----------
    def boost(self) -> bool:
        """Raise the floor to the ceiling so every tick holds the pool
        fully scaled while a tenant's SLO burns (queue-wait burn is
        capacity-shaped). Idempotent; False when already boosted or
        there is no headroom. The clear-edge revert is unboost()."""
        pool = self._runner._pool
        if pool is None or pool._closed or pool._terminated:
            return False
        ceiling = self._ceiling(pool)
        with self._lock:
            if self._boost_floor is not None or ceiling <= self.floor:
                return False
            self._boost_floor = self.floor
            self.floor = ceiling
        try:
            pool.resize(ceiling)
            self.scale_ups += 1
        except Exception:  # noqa: BLE001 - the raised floor still
            # holds; the next tick retries the resize
            logger.warning("serve: warm-pool boost resize failed",
                           exc_info=True)
        logger.info("serve: warm pool boosted to ceiling (%d workers) "
                    "while slo_burn stands", ceiling)
        return True

    def unboost(self) -> bool:
        """Restore the pre-boost floor (the normal idle scale-down
        brings the workers back down)."""
        with self._lock:
            if self._boost_floor is None:
                return False
            self.floor = self._boost_floor
            self._boost_floor = None
        logger.info("serve: warm pool boost lifted (floor back to %d)",
                    self.floor)
        return True

    def stats(self) -> Dict[str, object]:
        pool = self._runner._pool
        with self._lock:
            return {
                "floor": self.floor,
                "ceiling": self.ceiling or "pool",
                "workers": (int(getattr(pool, "_n_workers", 0))
                            if pool is not None else 0),
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "idle": self._idle_since is not None,
                "boosted": self._boost_floor is not None,
            }
