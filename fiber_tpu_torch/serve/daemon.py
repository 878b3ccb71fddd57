"""The serving daemon: ``fiber-tpu serve`` (docs/serving.md).

One long-lived process owns the backend (host agents / pod slice, or
local subprocess workers) and the shared scheduler/dispatch plane;
many clients connect over the same hardened authenticated channel the
host agents speak (:func:`fiber_tpu_torch.utils.serve.serve_request_reply`,
FIBER_CLUSTER_KEY) and multiplex jobs through it. Security posture is
the host agent's verbatim: no authkey on the Listener (accept returns
before the HMAC challenge, so hostile clients can't stall the loop),
per-connection authentication under hard deadlines, and a refusal to
bind non-loopback interfaces with the well-known development key.

Run it:

    fiber-tpu serve --backend local --processes 8
    python -m fiber_tpu_torch.serve.daemon --backend tpu

On start the daemon REPLAYS: any journaled job still marked
queued/running (a previous daemon died mid-job) is re-submitted from
its durable ledger — completed chunks restore, only the remainder
re-executes.
"""

from __future__ import annotations

import argparse
import os
import socket
import threading
import time
from typing import Any, Dict, Optional

from fiber_tpu_torch.serve import protocol
from fiber_tpu_torch.serve.admission import AdmissionController
from fiber_tpu_torch.serve.jobs import JobRunner
from fiber_tpu_torch.serve.warmpool import WarmPool
from fiber_tpu_torch.utils.logging import get_logger
from fiber_tpu_torch.utils.serve import serve_request_reply
from fiber_tpu_torch.utils.wire import Listener

logger = get_logger()

DEFAULT_SERVE_PORT = 7070


class ServeDaemon:
    """The RPC front + housekeeping thread around a JobRunner."""

    def __init__(self, port: Optional[int] = None,
                 authkey: Optional[bytes] = None,
                 bind: str = "127.0.0.1",
                 processes: Optional[int] = None,
                 runner: Optional[JobRunner] = None) -> None:
        from fiber_tpu_torch import config as _config
        from fiber_tpu_torch.host_agent import cluster_authkey

        cfg = _config.get()
        if (bind not in ("127.0.0.1", "localhost")
                and authkey is None
                and "FIBER_CLUSTER_KEY" not in os.environ):
            # Same posture as the host agent: the daemon runs arbitrary
            # client functions; with the well-known default key that is
            # unauthenticated RCE for anyone with network reach.
            raise RuntimeError(
                "fiber-tpu serve: refusing to bind non-loopback "
                f"interface {bind!r} with the default cluster key. Set "
                "FIBER_CLUSTER_KEY (e.g. `openssl rand -hex 32`) on "
                "every host, or bind 127.0.0.1."
            )
        if port is None:
            port = int(cfg.serve_port)
        if processes is None:
            processes = int(cfg.serve_processes) or None
        self._authkey = authkey or cluster_authkey()
        self._bind = bind
        self._listener = Listener((bind, port))
        self.port = self._listener.address[1]
        self.runner = runner or JobRunner(processes=processes)
        self.admission = AdmissionController.from_config(self.runner,
                                                         cfg)
        self.warm = WarmPool.from_config(self.runner, cfg)
        self._tick_s = float(cfg.serve_tick_s)
        self._stop = threading.Event()
        self._started = time.time()
        self._tick_thread: Optional[threading.Thread] = None
        self._metrics_port = int(cfg.metrics_port)
        self._metrics_server = None

    # -- lifecycle ------------------------------------------------------
    def start_background(self) -> None:
        """Replay + prewarm + housekeeping + serve loop, all on daemon
        threads (tests / embedding). ``main()`` instead serves on the
        calling thread."""
        self.startup()
        threading.Thread(target=self.serve_forever,
                         name="fiber-torch-serve-accept",
                         daemon=True).start()

    def startup(self) -> None:
        # Observability plane first: arm the archive writer for THIS
        # process (workers spawned below must not inherit it via
        # config), replay the archive tail so the SLO burn windows
        # survive a SIGKILL, and register the warm pool as the
        # slo_burn policy's boost target.
        from fiber_tpu_torch import config as _config
        from fiber_tpu_torch.telemetry.archive import ARCHIVE
        from fiber_tpu_torch.telemetry.policy import register_warm_pool
        from fiber_tpu_torch.telemetry.slo import SLO

        if _config.get().telemetry_enabled:
            ARCHIVE.enable(local=True)
            restored = SLO.replay()
            if restored:
                logger.info("serve: restored %d SLO observation(s) "
                            "from the archive", restored)
        register_warm_pool(self.warm)
        # Live Prometheus exposition beside the durable archive: one
        # daemon endpoint for both (metrics_port knob; 0 = off).
        if self._metrics_port:
            from fiber_tpu_torch import telemetry

            try:
                self._metrics_server = telemetry.serve_metrics(
                    port=self._metrics_port, bind=self._bind)
                logger.info("serve: metrics endpoint on %s:%d",
                            self._bind, self._metrics_server.port)
            except Exception:  # noqa: BLE001 - exposition is optional;
                # the daemon serves without it
                logger.warning("serve: metrics endpoint failed to "
                               "start", exc_info=True)
        replayed = self.runner.replay()
        if replayed:
            logger.info("serve: replayed %d in-flight job(s): %s",
                        len(replayed), ", ".join(replayed))
        try:
            self.warm.prewarm()
        except Exception:  # noqa: BLE001 - a cold pool still serves
            logger.warning("serve: prewarm failed; workers spawn on "
                           "first job", exc_info=True)
        self._tick_thread = threading.Thread(
            target=self._tick_loop, name="fiber-torch-serve-tick", daemon=True)
        self._tick_thread.start()

    def serve_forever(self) -> None:
        serve_request_reply(self._listener, self._authkey, self._stop,
                            self._answer, "fiber-torch-serve-conn")

    def stop(self, terminate_pool: bool = True) -> None:
        """Set the flag BEFORE closing the listener (the serve loop's
        contract), then tear the pool down."""
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # Wake the parked accept — closing the fd alone doesn't: the
        # in-flight accept syscall pins the listen socket open, so one
        # drain connect completes it and the loop sees the stop flag.
        host = self._bind if self._bind not in ("0.0.0.0", "::", "") \
            else "127.0.0.1"
        try:
            socket.create_connection((host, self.port), 0.5).close()
        except OSError:
            pass
        if self._metrics_server is not None:
            try:
                self._metrics_server.stop()
            except Exception:  # noqa: BLE001 - teardown is best-effort
                pass
            self._metrics_server = None
        try:
            self.runner.close(terminate=terminate_pool)
        except Exception:  # noqa: BLE001 - teardown is best-effort
            logger.warning("serve: pool teardown failed", exc_info=True)
        # Disarm the archive writer last: the pool teardown above still
        # emits flight events worth keeping, and a stopped daemon's
        # process (tests embed one) must not keep writing segments.
        from fiber_tpu_torch.telemetry.archive import ARCHIVE

        ARCHIVE.disable()

    def _tick_loop(self) -> None:
        from fiber_tpu_torch.telemetry.slo import SLO

        while not self._stop.is_set():
            try:
                self.admission.tick()
            except Exception:  # noqa: BLE001 - housekeeping must survive
                logger.exception("serve: admission tick failed")
            try:
                self.warm.tick()
            except Exception:  # noqa: BLE001
                logger.exception("serve: warm-pool tick failed")
            # SLO sweep: fold newly terminal jobs into the per-tenant
            # SLIs (each observation lands in the archive the moment it
            # is taken), then evaluate the multi-window burn rates —
            # the slo_burn raise/refresh/clear edge.
            try:
                SLO.observe_jobs(self.runner.terminal_views())
                SLO.evaluate()
            except Exception:  # noqa: BLE001
                logger.exception("serve: slo tick failed")
            self._stop.wait(self._tick_s)

    # -- RPC dispatch ---------------------------------------------------
    def _answer(self, request: Any) -> Any:
        op, payload = protocol.parse_request(request)
        from fiber_tpu_torch import telemetry

        telemetry.counter(
            "serve_ops", "Serve-daemon RPC ops, by op").inc(op=op)
        return getattr(self, "_op_" + op)(**payload)

    def _op_ping(self) -> str:
        return "pong"

    def _op_status(self) -> Dict[str, Any]:
        from fiber_tpu_torch.telemetry.archive import ARCHIVE
        from fiber_tpu_torch.telemetry.slo import SLO

        pool = self.runner._pool
        return {
            "protocol": protocol.PROTOCOL_VERSION,
            "pid": os.getpid(),
            "port": self.port,
            "uptime_s": time.time() - self._started,
            "jobs": self.runner.counts(),
            "warm_pool": self.warm.stats(),
            "admission": self.admission.stats(),
            "pool_alive": pool is not None and not pool._terminated,
            "slo": self._slo_summary(SLO),
            "archive": ARCHIVE.stats(),
            "metrics_port": (self._metrics_server.port
                             if self._metrics_server is not None
                             else None),
        }

    @staticmethod
    def _slo_summary(slo) -> Dict[str, Any]:
        """Compact SLO row for status (`fiber-tpu top --serve`
        columns); the full per-tenant surface is the `slo` verb."""
        snap = slo.snapshot()
        agg = snap["tenants"].get("*", {})
        burns = [b.get("burn_fast")
                 for objs in (t.get("burn", {})
                              for t in snap["tenants"].values())
                 for b in objs.values()
                 if isinstance(b, dict)
                 and isinstance(b.get("burn_fast"), (int, float))]
        return {
            "breached": snap["breached"],
            "observations": snap["observations"],
            "window_jobs": snap["window_jobs"],
            "error_rate": agg.get("error_rate"),
            "latency_p95": (agg.get("latency") or {}).get("p95"),
            "max_burn": max(burns) if burns else None,
        }

    def _op_submit(self, tenant: str, job_id: str, func: bytes,
                   items: list, star: bool = False,
                   chunksize: Optional[int] = None,
                   budget: Optional[dict] = None,
                   priority: float = 1.0) -> Dict[str, Any]:
        from fiber_tpu_torch import serialization

        protocol.check_tenant(tenant)
        self.admission.check(tenant, len(items))
        fn = serialization.loads(func)
        return self.runner.submit(tenant, job_id, fn, list(items),
                                  star=bool(star), chunksize=chunksize,
                                  budget=budget,
                                  priority=float(priority))

    def _op_poll(self, job_id: str) -> Dict[str, Any]:
        return self.runner.poll(job_id)

    def _op_results(self, job_id: str) -> bytes:
        return self.runner.results(job_id)

    def _op_cancel(self, job_id: str) -> Dict[str, Any]:
        return self.runner.cancel(job_id)

    def _op_jobs(self, tenant: Optional[str] = None) -> list:
        return self.runner.jobs(tenant)

    def _op_query(self, metric: str, since: Optional[float] = None,
                  until: Optional[float] = None,
                  labels: Optional[Dict[str, Any]] = None,
                  limit: int = 1000) -> list:
        """Archive time-range query (`fiber-tpu history`)."""
        from fiber_tpu_torch.telemetry.archive import ARCHIVE

        return ARCHIVE.query(str(metric), since=since, until=until,
                             labels=labels, limit=int(limit))

    def _op_slo(self, tenant: Optional[str] = None) -> Dict[str, Any]:
        """Per-tenant SLI/SLO snapshot (`fiber-tpu slo`)."""
        from fiber_tpu_torch.telemetry.slo import SLO

        if tenant is not None:
            protocol.check_tenant(tenant)
        return SLO.snapshot(tenant)

    def _op_shutdown(self) -> str:
        # Reply first, stop a beat later: the serve loop would turn a
        # raised SystemExit into a (False, ...) reply, so shutdown is a
        # timer, not an exception.
        threading.Timer(0.2, self.stop).start()
        return "stopping"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="fiber-tpu serve",
        description="Run the long-lived multi-tenant serving daemon.")
    parser.add_argument("--backend", default=None,
                        choices=("local", "tpu"),
                        help="cluster backend (default: FIBER_BACKEND "
                             "or local)")
    parser.add_argument("--port", type=int, default=None,
                        help="RPC port (default: serve_port config, "
                             f"{DEFAULT_SERVE_PORT})")
    parser.add_argument("--bind", default="127.0.0.1")
    parser.add_argument("--processes", type=int, default=None,
                        help="worker-slot ceiling for the shared pool "
                             "(default: serve_processes config)")
    parser.add_argument("--port-file", default="",
                        help="write the bound port here (atomic rename) "
                             "once listening — how supervisors and the "
                             "bench discover a --port 0 daemon")
    args = parser.parse_args(argv)
    if args.backend:
        os.environ["FIBER_BACKEND"] = args.backend
    import fiber_tpu_torch

    fiber_tpu_torch.init()
    daemon = ServeDaemon(port=args.port, bind=args.bind,
                         processes=args.processes)
    if args.port_file:
        tmp = f"{args.port_file}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(str(daemon.port))
        os.replace(tmp, args.port_file)
    logger.info("fiber-tpu serve: listening on %s:%d (backend=%s, "
                "pid=%d)", args.bind, daemon.port,
                os.environ.get("FIBER_BACKEND", "local"), os.getpid())
    daemon.startup()
    try:
        daemon.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
