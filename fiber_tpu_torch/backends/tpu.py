"""TPU backend: jobs are processes on the TPU pod slice's VM hosts.

Reference parity: this fills the slot of fiber/kubernetes_backend.py +
docker_backend.py — one driver per cluster substrate — except the substrate
is a TPU pod slice. Placement model (SURVEY.md §2 parallelism table): one
framework process per TPU-VM host drives that host's local devices; jobs
round-robin across hosts unless ``JobSpec.host_hint`` pins one.

Host discovery, in priority order:

1. ``tpu_hosts`` config / ``FIBER_TPU_HOSTS`` env: ``"ip[:port],..."`` —
   explicit list (also how CI points at a simulated localhost cluster);
2. ``sim:N``: spawn N local host agents (single-machine simulation of an
   N-host slice, the Docker-backend role in the reference's test matrix);
3. ``TPU_WORKER_HOSTNAMES`` env (set on real TPU-VMs by the platform).

Each host runs a fiber_tpu_torch host agent (fiber_tpu_torch/host_agent.py); this
backend is a thin RPC client over authenticated TCP.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import threading
import time
import weakref
from multiprocessing.connection import Client
from typing import Dict, List, Optional, Tuple

from fiber_tpu_torch import config
from fiber_tpu_torch.core import Backend, Job, JobSpec, ProcessStatus
from fiber_tpu_torch.host_agent import DEFAULT_AGENT_PORT, cluster_authkey
from fiber_tpu_torch.utils.logging import get_logger
from fiber_tpu_torch.utils.net import find_listen_address

logger = get_logger()


class AgentClient:
    """One authenticated connection per host agent, lock-serialized."""

    def __init__(self, host: str, port: int) -> None:
        self.host = host
        self.port = port
        self._conn = None
        self._lock = threading.Lock()

    def call(self, op: str, *args):
        with self._lock:
            try:
                if self._conn is None:
                    self._conn = Client((self.host, self.port),
                                        authkey=cluster_authkey())
                self._conn.send((op, *args))
                ok, payload = self._conn.recv()
            except (OSError, EOFError):
                # A failed round-trip poisons the stream (the next recv
                # could read this call's late reply); drop the connection
                # so the next call redials cleanly.
                if self._conn is not None:
                    try:
                        self._conn.close()
                    except OSError:
                        pass
                    self._conn = None
                raise
        if not ok:
            raise RuntimeError(
                f"agent {self.host}:{self.port} error: {payload}"
            )
        return payload

    def close(self) -> None:
        with self._lock:
            if self._conn is not None:
                try:
                    self._conn.close()
                except OSError:
                    pass
                self._conn = None


def _parse_hosts(spec: str,
                 default_port: int = 0) -> List[Tuple[str, int]]:
    """Parse ``ip[,ip:port,...]``; portless entries take
    ``default_port`` (the CLI passes the operator's --port so started
    and probed ports can never disagree) or DEFAULT_AGENT_PORT."""
    hosts = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            host, port_s = part.rsplit(":", 1)
            if not host or not port_s.isdigit():
                raise ValueError(
                    f"malformed host entry {part!r} (want ip or ip:port)"
                )
            hosts.append((host, int(port_s)))
        else:
            hosts.append((part, default_port or DEFAULT_AGENT_PORT))
    return hosts


class TpuBackend(Backend):
    name = "tpu"
    # Class-level defaults: shutdown_sim_cluster is atexit-registered
    # before the health plane is constructed, so a partial __init__
    # (sim agent failed to boot) must still shut down cleanly.
    _prober = None
    _detector = None

    def __init__(self) -> None:
        cfg = config.get()
        self._sim_agents: List[subprocess.Popen] = []
        hosts_spec = cfg.tpu_hosts or os.environ.get("FIBER_TPU_HOSTS", "")
        if hosts_spec.startswith("sim:"):
            n = int(hosts_spec.split(":", 1)[1])
            self._hosts = self._start_sim_cluster(n)
        elif hosts_spec:
            self._hosts = _parse_hosts(hosts_spec)
        else:
            names = os.environ.get("TPU_WORKER_HOSTNAMES", "")
            if not names:
                raise RuntimeError(
                    "tpu backend: no hosts (set tpu_hosts config, "
                    "FIBER_TPU_HOSTS, or run on a pod slice with "
                    "TPU_WORKER_HOSTNAMES)"
                )
            self._hosts = _parse_hosts(names)
        if not self._hosts:
            raise RuntimeError("tpu backend: empty host list")
        self._agents: Dict[Tuple[str, int], AgentClient] = {}
        self._rr = 0
        self._lock = threading.Lock()
        self._jobs: List[Job] = []
        # Per-host health plane (fiber_tpu_torch/health.py): the agent RPC
        # channel doubles as its heartbeat — a prober thread pings every
        # host each heartbeat_interval and any successful RPC beats the
        # detector. A host silent past suspect_timeout is suspected
        # (skipped by placement) but NOT permanent: agents restart, and
        # a later successful ping revives the host. The breaker
        # additionally blacklists hosts whose spawns keep FAILING even
        # though the agent answers (bad image, full disk) — backoff +
        # jitter, reset on the first spawn that succeeds.
        cfg = config.get()
        from fiber_tpu_torch.health import (
            CircuitBreaker, FailureDetector, Heartbeater,
        )

        self._host_breaker = CircuitBreaker(
            fail_threshold=int(cfg.spawn_breaker_threshold),
            base_backoff=float(cfg.spawn_breaker_backoff),
            max_backoff=float(cfg.spawn_breaker_backoff_max),
        )
        self._detector = None
        self._prober = None
        if float(cfg.heartbeat_interval or 0) > 0 \
                and float(cfg.suspect_timeout or 0) > 0:
            self._detector = FailureDetector(
                float(cfg.suspect_timeout), self._on_host_suspect,
                permanent=False, name="fiber-torch-agent-detector",
                on_revive=self._on_host_revive,
            ).start()
            self._prober = Heartbeater(
                self._probe_hosts, float(cfg.heartbeat_interval),
                name="fiber-torch-agent-prober",
            ).start()
        # Policy-plane replication driver (telemetry/policy.py
        # replicate_and_boost): lets a heartbeat_age / throughput_drop
        # anomaly pre-emptively copy precious digests BEFORE the
        # failure detector declares anyone suspect. Weakref so a
        # registered driver never pins a dead backend alive.
        from fiber_tpu_torch.store.replicate import REPLICATOR

        wself = weakref.ref(self)

        def _drive(reason: str) -> int:
            b = wself()
            return (b._replicate_precious(reason=reason)
                    if b is not None else 0)

        REPLICATOR.register_driver(_drive)
        logger.info("tpu backend: %d host(s): %s", len(self._hosts),
                    self._hosts)

    # ------------------------------------------------------------------
    def _start_sim_cluster(self, n: int) -> List[Tuple[str, int]]:
        """N local agents simulating an N-host pod slice (loopback-only)."""
        import atexit

        # Registered before any spawn so a partial startup failure still
        # reaps the agents that did come up.
        atexit.register(self.shutdown_sim_cluster)
        from fiber_tpu_torch.utils.misc import package_pythonpath

        # Agents must import fiber_tpu_torch no matter where the user's script
        # runs from (a bare `-m fiber_tpu_torch.host_agent` only works when cwd
        # happens to contain the package).
        env = dict(os.environ, PYTHONPATH=package_pythonpath())
        # Each sim agent models a whole pod HOST, so it advertises a
        # host-sized core capacity regardless of this machine's physical
        # count (the agents share cores, like the reference's Docker
        # containers): otherwise packed jobs (cpu_per_job>1) would be
        # unspawnable on small CI machines and the pool would retry
        # forever. Override with FIBER_SIM_HOST_CORES.
        sim_cores = int(os.environ.get("FIBER_SIM_HOST_CORES", 0)) \
            or max(8, os.cpu_count() or 1)
        hosts = []
        for _ in range(n):
            proc = subprocess.Popen(
                [sys.executable, "-m", "fiber_tpu_torch.host_agent",
                 "--port", "0", "--announce", "--bind", "127.0.0.1",
                 "--cores", str(sim_cores)],
                stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                text=True,
                env=env,
            )
            self._sim_agents.append(proc)
            line = proc.stdout.readline().strip()
            if not line.startswith("AGENT_PORT"):
                self.shutdown_sim_cluster()
                raise RuntimeError(
                    f"sim agent failed to start (got {line!r})"
                )
            port = int(line.split()[1])
            hosts.append(("127.0.0.1", port))
        return hosts

    def _probe_hosts(self) -> None:
        """One ping round (runs on the prober thread each interval). A
        host that answers ANY rpc is alive; a failed ping is left to the
        detector's deadline — one lost packet must not mark a host."""
        for host in list(self._hosts):
            try:
                self._agent(host).call("ping")
            except Exception:
                continue  # silence accrues; the detector owns the call
            detector = self._detector
            if detector is not None:
                detector.beat(host)

    def _on_host_suspect(self, host) -> None:
        logger.warning(
            "health: host agent %s:%s silent past suspect_timeout; "
            "suspending placement on it (revives on next answer)",
            host[0], host[1])
        # Host-loss tolerance (docs/robustness.md): precious digests —
        # ledger-journaled result payloads and active broadcasts — gain
        # a replica on a healthy host NOW, while "suspect" may still
        # become "dead". Off the detector thread: a slow agent push must
        # never delay further declarations.
        try:
            if bool(config.get().store_replicate):
                threading.Thread(
                    target=self._replicate_precious, args=(host,),
                    name="fiber-torch-store-replicate", daemon=True,
                ).start()
        except Exception:  # noqa: BLE001 - durability bonus only
            logger.warning("store: replication kickoff failed",
                           exc_info=True)

    def _on_host_revive(self, host) -> None:
        """A declared-suspect host answered again: clear its spawn
        breaker so placement resumes immediately — an open period earned
        while the host was down must not park a recovered host."""
        self._host_breaker.record_success(host)
        logger.info("health: host %s:%s revived; spawn breaker cleared",
                    host[0], host[1])

    def _replicate_precious(self, suspect=None,
                            reason: str = "suspect") -> int:
        """Copy precious digests to healthy hosts. Two triggers share
        this routine: a declared-suspect host (``suspect`` excluded
        from targets) and the policy plane's pre-emptive drive on a
        heartbeat_age / throughput_drop anomaly (no suspect yet —
        every healthy host is a target)."""
        from fiber_tpu_torch import store as storemod
        from fiber_tpu_torch.store.replicate import REPLICATOR

        targets = [h for h in self._hosts
                   if h != suspect and self._host_healthy(h)]
        local = storemod.local_store()
        key = (f"{suspect[0]}:{suspect[1]}" if suspect is not None
               else str(reason))
        return REPLICATOR.replicate_for_suspect(
            key, targets,
            get_bytes=local.get_bytes,
            host_has=lambda h, d: self._agent(h).call("store_has", d),
            host_put=lambda h, d, data: self._agent(h).call(
                "store_put", d, data),
        )

    def host_health(self) -> Dict[str, str]:
        """Operator-facing snapshot: host -> 'ok'|'suspect'|'open'."""
        out = {}
        for host in self._hosts:
            key = f"{host[0]}:{host[1]}"
            if self._detector is not None \
                    and self._detector.is_suspect(host):
                out[key] = "suspect"
            elif not self._host_breaker.allow(host):
                out[key] = "open"
            else:
                out[key] = "ok"
        return out

    def shutdown_sim_cluster(self) -> None:
        if self._prober is not None:
            self._prober.stop()
        if self._detector is not None:
            self._detector.stop()
        for proc in self._sim_agents:
            if proc.poll() is None:
                proc.terminate()
        for proc in self._sim_agents:
            try:
                proc.wait(5)
            except subprocess.TimeoutExpired:
                proc.kill()
        self._sim_agents = []

    def probe_available(self) -> None:
        """Raise unless at least one host agent is reachable. Called by
        the registry for *sniffed* (non-explicit) selections only: a
        TPU-shaped environment without running agents (e.g. a PJRT
        tunnel plugin injecting TPU_WORKER_HOSTNAMES) must fall back to
        the local backend instead of turning every job launch into a
        connection-refused retry loop. Sim clusters spawn their own
        agents in __init__, so they always pass."""
        import socket as pysocket
        from concurrent.futures import ThreadPoolExecutor

        def try_one(host_port):
            host, port = host_port
            try:
                with pysocket.create_connection((host, port), timeout=2.0):
                    return None
            except OSError as exc:
                return f"{host}:{port}: {exc}"

        # Concurrent probes: the failure path costs ~one connect timeout
        # total, not 2s x hosts (first success wins either way).
        with ThreadPoolExecutor(max_workers=min(16, len(self._hosts))) \
                as pool:
            errors = [e for e in pool.map(try_one, self._hosts)
                      if e is not None]
        if len(errors) < len(self._hosts):
            return  # at least one agent answered
        raise RuntimeError(
            "no fiber-tpu host agent reachable "
            f"({'; '.join(errors[:4])}) — start agents with "
            "`fiber-tpu up` / `fiber-tpu agent`, or set "
            "FIBER_BACKEND=local"
        )

    def _agent(self, host: Tuple[str, int]) -> AgentClient:
        with self._lock:
            client = self._agents.get(host)
            if client is None:
                client = AgentClient(*host)
                self._agents[host] = client
            return client

    def _host_healthy(self, host: Tuple[str, int]) -> bool:
        if self._detector is not None and self._detector.is_suspect(host):
            return False
        return self._host_breaker.allow(host)

    def _pick_host(self, spec: JobSpec) -> Tuple[str, int]:
        if spec.host_hint:
            for host in self._hosts:
                if host[0] == spec.host_hint or \
                        f"{host[0]}:{host[1]}" == spec.host_hint:
                    return host  # a pin overrides health (ring ranks
                    # etc. are placement-significant; fail loudly there)
            raise ValueError(f"host_hint {spec.host_hint!r} not in cluster")
        # Round-robin over HEALTHY hosts: suspected agents and
        # open-breaker targets are skipped. With every host unhealthy,
        # fall through to plain round-robin — a wrong placement beats a
        # placement deadlock, and the attempt itself is the breaker's
        # half-open trial.
        with self._lock:
            n = len(self._hosts)
            for step in range(1, n + 1):
                cand = self._hosts[(self._rr + step) % n]
                if self._host_healthy(cand):
                    self._rr = (self._rr + step) % n
                    return cand
            host = self._hosts[self._rr % n]
            self._rr += 1
        return host

    # ------------------------------------------------------------------
    def create_job(self, job_spec: JobSpec) -> Job:
        host = self._pick_host(job_spec)
        agent = self._agent(host)
        env = dict(job_spec.env or {})
        # Placement identity for the scheduler plane
        # (docs/scheduling.md): only this backend knows which host the
        # job landed on, so it stamps the key — the same "ip:port" the
        # host tables (host_health/store_stats/locate_object) use —
        # into the job env; pool workers echo it in "ready" frames.
        env.setdefault("FIBER_HOST_KEY", f"{host[0]}:{host[1]}")
        # Resource hints become agent-enforced limits (affinity + rlimit),
        # the reference's k8s/docker limit role. Device jobs keep all host
        # cores — pinning a jax host process to cpu_per_job cores would
        # starve its runtime threads.
        limits = {}
        if job_spec.cpu and not (job_spec.tpu or job_spec.gpu):
            limits["cpu"] = int(job_spec.cpu)
        if job_spec.mem:
            limits["mem"] = int(job_spec.mem)
        try:
            pid, log_path = agent.call(
                "spawn", job_spec.command, job_spec.cwd, env,
                job_spec.name, limits,
            )
        except Exception:
            if self._host_breaker.record_failure(host):
                logger.warning(
                    "health: spawn breaker OPEN for host %s:%s after "
                    "repeated failures; placement backs off it",
                    host[0], host[1])
            raise
        self._host_breaker.record_success(host)
        if self._detector is not None:
            self._detector.beat(host)  # an answering agent is alive
        job = Job({"host": host, "pid": pid, "log": log_path},
                  jid=f"{host[0]}:{host[1]}/{pid}")
        job.host = host[0]
        with self._lock:
            self._jobs.append(job)
        return job

    def _agent_for_job(self, job: Job) -> Tuple[AgentClient, int]:
        data = job.data
        return self._agent(data["host"]), data["pid"]

    def get_job_status(self, job: Job) -> ProcessStatus:
        agent, pid = self._agent_for_job(job)
        rc = agent.call("poll", pid)
        return ProcessStatus.STARTED if rc is None else ProcessStatus.STOPPED

    def get_job_logs(self, job: Job) -> str:
        agent, pid = self._agent_for_job(job)
        return agent.call("logs", pid)

    def wait_for_job(self, job: Job, timeout: Optional[float]) -> Optional[int]:
        agent, pid = self._agent_for_job(job)
        # Short bounded agent-side waits so one join never pins the shared
        # agent channel (other RPCs to this host interleave between slices).
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            slice_ = 0.5
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return agent.call("poll", pid)
                slice_ = min(slice_, remaining)
            rc = agent.call("wait", pid, slice_)
            if rc is not None:
                return rc

    def terminate_job(self, job: Job) -> None:
        agent, pid = self._agent_for_job(job)
        agent.call("signal", pid, int(signal.SIGTERM))

    def kill_job(self, job: Job) -> None:
        agent, pid = self._agent_for_job(job)
        agent.call("signal", pid, int(signal.SIGKILL))

    def _resolved_hosts_spec(self) -> str:
        return ",".join(f"{h}:{p}" for h, p in self._hosts)

    def child_env(self) -> Dict[str, str]:
        # Children must dial THIS cluster's agents — never re-expand a
        # "sim:N" spec into a private cluster of their own.
        return {
            "FIBER_TPU_HOSTS": self._resolved_hosts_spec(),
            "FIBER_BACKEND": "tpu",
        }

    def child_config(self) -> Dict[str, str]:
        return {"tpu_hosts": self._resolved_hosts_spec(), "backend": "tpu"}

    def default_pool_size(self) -> int:
        # Pool treats `processes` as the TOTAL sub-worker count and packs
        # cpu_per_job of them per spawned job — so the natural default is
        # one job per host × its packing factor (fills every host).
        from fiber_tpu_torch import config

        cpu_per_job = max(1, int(config.get().cpu_per_job))
        return len(self._hosts) * cpu_per_job

    def get_listen_addr(self) -> Tuple[str, int, str]:
        if all(h[0] in ("127.0.0.1", "localhost") for h in self._hosts):
            return ("127.0.0.1", 0, "lo")
        ip = find_listen_address() or "127.0.0.1"
        return (ip, 0, "eth0")

    def list_jobs(self) -> List[Job]:
        with self._lock:
            jobs = list(self._jobs)
        live = []
        finished = set()
        for job in jobs:
            try:
                if self.get_job_status(job) == ProcessStatus.STARTED:
                    live.append(job)
                else:
                    finished.add(id(job))
            except Exception:
                pass  # transient RPC failure: keep tracking the job
        # Prune only jobs *observed finished* — jobs created concurrently
        # with the polling above (or whose poll failed) stay tracked.
        with self._lock:
            self._jobs = [j for j in self._jobs if id(j) not in finished]
        return live

    # -- file staging (fiber cp parity) --------------------------------
    def put_file(self, path: str, data: bytes, hosts=None,
                 mode: int = 0o644) -> None:
        for host in (hosts or self._hosts):
            self._agent(host).call("put_file", path, data, mode)

    def stage_code(self, digest: str, files) -> bool:
        """Push the workspace snapshot to every agent, content-addressed:
        a host that already has ``code/<digest>/.fiber-complete`` is
        skipped, so repeat spawns and repeat runs cost one RPC per host."""
        rel_root = f"code/{digest}"
        marker = f"{rel_root}/.fiber-complete"
        for host in self._hosts:
            agent = self._agent(host)
            try:
                agent.call("get_file", marker)
                continue  # this host already has the snapshot
            except Exception:
                pass
            for rel, data, mode in files:
                agent.call("put_file", f"{rel_root}/{rel}", data, mode)
            # Written last: a crashed staging run is retried, not trusted.
            agent.call("put_file", marker, b"ok", 0o644)
        return True

    def get_file(self, path: str, host=None) -> bytes:
        host = host or self._hosts[0]
        return self._agent(host).call("get_file", path)

    # -- object store (docs/objectstore.md) ----------------------------
    def put_object(self, digest: str, data: bytes, hosts=None) -> int:
        """Prestage one serialized store object into every host's cache
        tier (skipping hosts that already have it): workers there
        resolve the ref from local disk instead of dialing the owner —
        the explicit broadcast path for very hot objects. Returns the
        number of hosts that received bytes."""
        pushed = 0
        for host in (hosts or self._hosts):
            agent = self._agent(host)
            try:
                if agent.call("store_has", digest):
                    continue
            except Exception:
                pass  # can't tell; push anyway
            agent.call("store_put", digest, bytes(data))
            pushed += 1
        return pushed

    def host_suspect(self, host_key: str) -> bool:
        """Scheduler-plane health input: True when the keyed host is
        currently suspect (silent past suspect_timeout) or its spawn
        breaker is open — the pool's handout gate parks its workers'
        requests while healthier peers exist (docs/scheduling.md)."""
        host, _, port_s = host_key.rpartition(":")
        if not host or not port_s.isdigit():
            return False
        key = (host, int(port_s))
        if self._detector is not None and self._detector.is_suspect(key):
            return True
        return not self._host_breaker.allow(key)

    def locate_object(self, digest: str) -> List[str]:
        """Hosts whose object cache already holds ``digest`` (agent
        ``store_has``), keyed like :meth:`host_health` — the scheduler's
        placement probe for prestaged broadcasts. Best-effort: an
        unreachable agent just drops out of the answer."""
        out: List[str] = []
        for host in self._hosts:
            try:
                if self._agent(host).call("store_has", digest):
                    out.append(f"{host[0]}:{host[1]}")
            except Exception:  # noqa: BLE001 - locality is optional
                continue
        return out

    def fetch_object(self, digest: str) -> Optional[bytes]:
        """Pull one store object from whichever host cache still holds
        it (agent ``store_has`` + ``store_get``), digest-verified — the
        recovery path of ``fiber-tpu resume``: a journaled result whose
        master-disk copy is gone is fetched from the per-host stores
        instead of being recomputed. None when no host has it."""
        import hashlib as _hashlib

        for host in self._hosts:
            try:
                if not self._agent(host).call("store_has", digest):
                    continue
                data = bytes(self._agent(host).call("store_get", digest))
                if _hashlib.sha256(data).hexdigest() == digest:
                    return data
            except Exception:  # noqa: BLE001 - try the next host
                continue
        return None

    def store_stats(self) -> Dict[str, dict]:
        """Per-host object-cache counters, the store-plane sibling of
        :meth:`host_health` (same operator surface, same host keys)."""
        out: Dict[str, dict] = {}
        for host in self._hosts:
            key = f"{host[0]}:{host[1]}"
            try:
                out[key] = self._agent(host).call("store_stats")
            except Exception as exc:  # noqa: BLE001 - operator snapshot
                out[key] = {"error": repr(exc)}
        return out

    # -- telemetry (docs/observability.md) -----------------------------
    def collect_postmortem(self, host_key: str) -> Optional[dict]:
        """One host's black box (the agent's ``postmortem`` op): flight
        events, stack dump, and any crash bundles workers there flushed.
        ``host_key`` is the scheduler-plane ``ip:port`` key workers
        self-report; None when it doesn't name a known agent."""
        host, _, port_s = host_key.rpartition(":")
        if not host or not port_s.isdigit():
            return None
        return self._agent((host, int(port_s))).call("postmortem")

    def cluster_metrics(self) -> Dict[str, dict]:
        """Per-host telemetry snapshots keyed like :meth:`host_health` /
        :meth:`store_stats` (one operator surface), via each agent's
        ``telemetry_snapshot`` op. An unreachable host contributes an
        ``error`` entry instead of failing the sweep."""
        return self._sweep("telemetry_snapshot")

    def cluster_timeseries(self, history: int = 120) -> Dict[str, dict]:
        """Per-host continuous-monitor snapshots (time-series rings,
        derived rates, anomaly-watchdog state) via each agent's
        ``monitor_snapshot`` op — the data plane of ``fiber-tpu top``,
        keyed like :meth:`cluster_metrics`."""
        return self._sweep("monitor_snapshot", int(history))

    def collect_profiles(self, seconds: float = 1.0,
                         hz: float = 97.0) -> Dict[str, dict]:
        """Per-host on-demand sampling profiles (agent ``profile_dump``
        op): each agent samples its own process for ``seconds`` at
        ``hz`` and returns flamegraph folded stacks. Same host keys as
        the other sweeps; an unreachable host contributes ``error``."""
        return self._sweep("profile_dump", float(seconds), float(hz))

    def cluster_devices(self) -> Dict[str, dict]:
        """Per-host device-telemetry snapshots (agent
        ``device_snapshot`` op): transfer bytes+seconds, compile
        count+seconds, HBM / live-array stats (honest None on CPU
        hosts), recompile state and last MFU — the data plane of
        ``fiber-tpu devices``, keyed like :meth:`cluster_metrics`
        (docs/observability.md "Device telemetry")."""
        return self._sweep("device_snapshot")

    def cluster_costs(self) -> Dict[str, dict]:
        """Per-host accounting snapshots (agent ``cost_snapshot`` op):
        each host process's billing-key -> cost-vector table — the data
        plane of ``fiber-tpu top --costs``, keyed like
        :meth:`cluster_metrics` (docs/observability.md "Resource
        accounting")."""
        return self._sweep("cost_snapshot")

    def _sweep(self, op: str, *args) -> Dict[str, dict]:
        """One telemetry RPC against every host, error-isolating — the
        shared shape of cluster_metrics / cluster_timeseries /
        collect_profiles."""
        out: Dict[str, dict] = {}
        for host in self._hosts:
            key = f"{host[0]}:{host[1]}"
            try:
                out[key] = self._agent(host).call(op, *args)
            except Exception as exc:  # noqa: BLE001 - operator snapshot
                out[key] = {"error": repr(exc)}
        return out


def make_backend() -> TpuBackend:
    return TpuBackend()
