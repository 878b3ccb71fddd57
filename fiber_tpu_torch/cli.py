"""The ``fiber-tpu-torch`` command-line tool: ``python -m
fiber_tpu_torch.cli``, or the ``fiber-tpu-torch`` console script.

The port's counterpart of the JAX package's ``fiber-tpu`` CLI, with the
same commands, options and output formats (so that both render one
snapshot alike). Two things differ: ``doctor`` probes ``torch.cuda`` in
a subprocess where the JAX CLI probes ``jax.devices()``, and ``resume``
and ``jobs`` read the port's ledgers (its staging root,
``~/.fiber_tpu_torch/staging``).

Reference parity: fiber/cli.py (``fiber run`` builds an image and launches
the master in the cluster; ``fiber cp`` stages files through a PVC pod).
The equivalents here drive host agents instead of a container platform:

=============  ==========================================================
run            run a user program with the framework configured
               (``--backend``, ``--hosts``; the program's fiber_tpu_torch
               Processes land on the cluster)
sim            run a user program against a simulated N-host cluster on
               this machine (the Docker-backend role in the reference's
               test matrix)
agent          run the per-host agent daemon (started on every TPU-VM)
up             print (or execute) the commands that start agents on every
               host of a pod slice via gcloud ssh
status         ping every host agent and report liveness/host info
metrics        fetch every agent's telemetry snapshot (counters/timers;
               --prom renders Prometheus v0.0.4 text exposition;
               --watch polls and prints deltas/rates between snapshots)
top            live auto-refreshing per-host table (evals/s, inflight,
               queue, bytes/s, heartbeat age, anomaly flags) from the
               agents' continuous-monitor plane
profile        run a script under the wall-clock sampling profiler (or,
               with --hosts, pull on-demand agent profiles) and write
               flamegraph folded output
explain        classify where a traced map's time went (straggler /
               locality-miss / backpressure / transport-stall /
               store-fetch) from a trace artifact + flight events
postmortem     list/print black-box bundles (dead-worker flight events
               + stack dumps), locally or pulled from host agents
cost           render one job's CostReport (per-map/per-tenant resource
               accounting: tasks, cpu-seconds, wire bytes, store bytes,
               device costs; --hosts pulls the live per-host ledgers)
resume         resume a crashed durable map from its write-ahead ledger
               (``Pool.map(..., job_id=...)``): restore journaled
               results, re-execute only the remainder
jobs           list durable-map ledgers under the staging root
logs           fetch a job's log tail by jid (host:port/jobid)
cp             stage files to/from hosts through the agents
=============  ==========================================================
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import shlex
import subprocess
import sys
import time
from typing import List, Optional


def _hosts_from_args(args) -> str:
    hosts = args.hosts or os.environ.get("FIBER_TPU_HOSTS", "")
    if not hosts:
        raise SystemExit("error: --hosts (or FIBER_TPU_HOSTS) is required")
    return hosts


def _parse_hosts_cli(spec: str, default_port: int = 0):
    from fiber_tpu_torch.backends.tpu import _parse_hosts

    try:
        return _parse_hosts(spec, default_port)
    except ValueError as err:
        raise SystemExit(f"error: {err}") from None


def _resolve_cli_hosts(args):
    """The one host-resolution story for every agent-facing subcommand
    (status/doctor/cp/down): explicit --hosts (or FIBER_TPU_HOSTS)
    parsed with --port as the portless default, else --tpu derives the
    worker addresses via gcloud describe — the same seam `up` uses.
    Precedence matches `up`: explicit --tpu outranks a stale env
    (stopping/probing cluster B must not touch cluster A)."""
    from fiber_tpu_torch.host_agent import DEFAULT_AGENT_PORT

    port = getattr(args, "port", 0)
    if getattr(args, "tpu", "") and not args.hosts:
        try:
            return _derive_tpu_probe_hosts(
                args.tpu, getattr(args, "zone", ""),
                port or DEFAULT_AGENT_PORT)
        except RuntimeError as err:
            raise SystemExit(
                f"error: could not derive worker addresses from "
                f"gcloud describe ({err}); pass --hosts ip[:port],...")
    spec = args.hosts or os.environ.get("FIBER_TPU_HOSTS", "")
    if not spec:
        raise SystemExit(
            "error: --hosts (or FIBER_TPU_HOSTS) or --tpu is required")
    return _parse_hosts_cli(spec, port)


def _run_script(script: str, script_args: List[str]) -> None:
    sys.argv = [script] + list(script_args)
    sys.path.insert(0, os.path.dirname(os.path.abspath(script)) or ".")
    runpy.run_path(script, run_name="__main__")


def cmd_run(args) -> int:
    if args.backend:
        os.environ["FIBER_BACKEND"] = args.backend
    if args.hosts:
        os.environ["FIBER_TPU_HOSTS"] = args.hosts
        os.environ.setdefault("FIBER_BACKEND", "tpu")
    if args.submit:
        return _submit_master(args)
    _run_script(args.script, args.script_args)
    return 0


def _submit_master(args) -> int:
    """Launch the *master* as a cluster job (reference: ``fiber run``
    starts the master in the cluster and attaches to its logs,
    fiber/cli.py:346-414). The workspace ships via the staging plane;
    the job runs from the staged snapshot, so its own Processes stage
    nothing extra and land on the same cluster."""
    import time

    from fiber_tpu_torch.backends import get_backend
    from fiber_tpu_torch.core import JobSpec, ProcessStatus
    from fiber_tpu_torch.utils.misc import package_pythonpath
    from fiber_tpu_torch.utils.staging import (
        get_workspace_snapshot,
        stage_workspace,
    )

    if args.backend and args.backend != "tpu":
        raise SystemExit(
            "error: --submit launches the master through cluster agents "
            "and requires the tpu backend (drop --backend or use tpu)"
        )
    script = os.path.relpath(os.path.abspath(args.script), os.getcwd())
    if script.startswith(".."):
        raise SystemExit(
            "error: --submit requires the script inside the cwd "
            "(the staged workspace)"
        )
    try:
        backend = get_backend("tpu")
    except Exception as err:
        raise SystemExit(f"error: {err}") from None
    if getattr(backend, "_sim_agents", None) and not args.follow:
        # Sim agents are children of THIS process: detaching would reap
        # them at exit and orphan-kill the just-submitted master.
        raise SystemExit(
            "error: --submit on a sim cluster requires --follow "
            "(the simulated agents die with this CLI process)"
        )
    digest, _files = get_workspace_snapshot()
    staged = stage_workspace(backend)
    if not staged:
        raise SystemExit("error: backend cannot stage code")
    # The snapshot filters (extension allowlist, size caps) must not have
    # dropped the script itself, or the remote job dies at `can't open
    # file` with the failure visible only in remote logs.
    staged_paths = {rel for rel, _, _ in get_workspace_snapshot()[1]}
    if script not in staged_paths:
        raise SystemExit(
            f"error: {script!r} is not part of the staged snapshot "
            "(stageable extensions: .py and small text/config files)"
        )
    env = {
        "FIBER_BACKEND": "tpu",
        "FIBER_TPU_HOSTS": backend._resolved_hosts_spec(),
        "FIBER_STAGED_CODE": staged,
        "PYTHONPATH": staged + os.pathsep + package_pythonpath(),
    }
    spec = JobSpec(
        command=[args.python, script] + list(args.script_args),
        name="fiber-torch-master",
        env=env,
        cwd=staged,
    )
    job = backend.create_job(spec)
    print(f"submitted master job {job.jid}", flush=True)
    if not args.follow:
        print(f"# follow with: fiber-tpu status --hosts "
              f"{backend._resolved_hosts_spec()}")
        return 0
    # Attach: stream the log tail incrementally while the job runs.
    printed = 0
    while True:
        running = backend.get_job_status(job) == ProcessStatus.STARTED
        logs = backend.get_job_logs(job)
        if len(logs) > printed:
            sys.stdout.write(logs[printed:])
            sys.stdout.flush()
            printed = len(logs)
        if not running:
            break
        time.sleep(1.0)
    return int(backend.wait_for_job(job, 5) or 0)


def cmd_sim(args) -> int:
    os.environ["FIBER_BACKEND"] = "tpu"
    os.environ["FIBER_TPU_HOSTS"] = f"sim:{args.n}"
    _run_script(args.script, args.script_args)
    return 0


def cmd_agent(args) -> int:
    from fiber_tpu_torch import host_agent

    argv = ["--port", str(args.port), "--bind", args.bind]
    if args.announce:
        argv.append("--announce")
    if args.unrestricted_files:
        argv.append("--unrestricted-files")
    return host_agent.main(argv)


def _run_shell(cmd: str) -> int:
    """The one seam through which `up` touches the outside world (ssh /
    gcloud) — tests monkeypatch this to stand up real local agents and
    drive the whole bring-up end to end without cloud credentials."""
    return subprocess.call(cmd, shell=True)


def _run_shell_capture(cmd: str):
    """Output-capturing twin of :func:`_run_shell` (tests monkeypatch
    both as the same mocked shell seam): returns
    ``(rc, stdout, stderr)``. stderr rides along so a failed gcloud's
    actionable error text ("reauthentication required", wrong zone)
    reaches the operator instead of dying captured."""
    proc = subprocess.run(cmd, shell=True, capture_output=True, text=True)
    return proc.returncode, proc.stdout, proc.stderr or ""


def _derive_tpu_probe_hosts(tpu: str, zone: str, port: int):
    """Resolve a TPU pod's worker addresses so `up --tpu` can always
    verify the agents it started (verification must be
    derived, never optional). gcloud is the source of truth — the
    reference automates the same wait-until-running step against the
    k8s API (fiber/cli.py:338-414); here `describe --format json`
    lists one networkEndpoint per pod worker. External IPs win (the
    operator's box is usually outside the VPC); internal `ipAddress`
    is the fallback. Raises RuntimeError when nothing usable comes
    back — the caller treats that as a verification failure, not a
    skip."""
    cmd = (
        f"gcloud compute tpus tpu-vm describe {shlex.quote(tpu)} "
        + (f"--zone {shlex.quote(zone)} " if zone else "")
        + "--format json"
    )
    rc, out, err = _run_shell_capture(cmd)
    if rc != 0:
        why = err.strip().splitlines()
        detail = f": {why[-1][:200]}" if why else ""
        raise RuntimeError(f"gcloud describe exited {rc}{detail}")
    try:
        data = json.loads(out)
    except ValueError as err:
        raise RuntimeError(f"describe output was not JSON: {err}")
    hosts = []
    for ep in data.get("networkEndpoints") or []:
        ip = ((ep.get("accessConfig") or {}).get("externalIp")
              or ep.get("ipAddress"))
        if ip:
            hosts.append((ip, port))
    if not hosts:
        raise RuntimeError("describe listed no usable networkEndpoints")
    return hosts


def _wait_for_agents(hosts, timeout: float) -> int:
    """Poll every agent until it answers ping (the reference's
    wait-until-pod-running step, fiber/cli.py:402-410); prints one
    status line per host. Returns 0 when all answered. Keyed by
    (host, port) — several agents on one host (the local multi-agent
    layout) are distinct waits."""
    deadline = time.time() + timeout
    remaining = set(hosts)
    while remaining:
        for host, port in sorted(remaining):
            try:
                info, _ = _probe_agent(host, port)
            except Exception:
                continue
            print(f"up: {host}:{port} agent live "
                  f"(cpus={info.get('cpu_count')})")
            remaining.discard((host, port))
        if not remaining:
            return 0
        if time.time() > deadline:
            for host, port in sorted(remaining):
                print(f"up: {host}:{port} NOT answering after "
                      f"{timeout:.0f}s — check /tmp/fiber-agent.log "
                      "on the host", file=sys.stderr)
            return 1
        time.sleep(0.5)
    return 0


def cmd_up(args) -> int:
    """Bring the pod slice up: start an agent on every host over
    ssh/gcloud, wait until they all answer, and report — the
    reference's automated bring-up (fiber/cli.py:338-414: build, create
    pod, attach) redesigned for TPU-VM slices. ``--dry-run`` prints the
    commands instead of running them.

    A fresh cluster key is generated when the operator hasn't set one —
    pod agents bind non-loopback, and the agent refuses that with the
    well-known default key.
    """
    import secrets
    import shutil

    from fiber_tpu_torch.host_agent import DEFAULT_AGENT_PORT

    port = args.port or DEFAULT_AGENT_PORT
    key = os.environ.get("FIBER_CLUSTER_KEY")
    if not key:
        key = secrets.token_hex(32)
        print(
            "# generated cluster key — export it before running the "
            f"master:\nexport FIBER_CLUSTER_KEY={key}",
            file=sys.stderr,
        )
    execute = not args.dry_run
    if args.execute:
        print(
            "# note: --execute is obsolete — `up` executes by default "
            "(use --dry-run to only print the commands)",
            file=sys.stderr,
        )

    # Agents must share the operator's cluster key or every later
    # master/status/cp call fails HMAC auth.
    def agent_cmd(agent_port: int) -> str:
        return (
            f"FIBER_CLUSTER_KEY={shlex.quote(key)} "
            f"nohup {args.python} -m fiber_tpu_torch.host_agent "
            f"--port {agent_port} --bind 0.0.0.0 "
            ">/tmp/fiber-agent.log 2>&1 &"
        )

    def parse_up_hosts(spec: str):
        # Portless entries take --port so the STARTED port and the
        # PROBED port can never disagree.
        return _parse_hosts_cli(spec, port)

    if args.tpu:
        driver = "gcloud"
        cmds = [(
            f"gcloud compute tpus tpu-vm ssh {shlex.quote(args.tpu)} "
            + (f"--zone {shlex.quote(args.zone)} " if args.zone else "")
            + "--worker all --command " + shlex.quote(agent_cmd(port))
        )]
        # gcloud addresses workers by name; probing needs addresses —
        # the worker agents all listen on `port`, so --hosts entries
        # here must carry that port (or none, which defaults to it).
        probe_hosts = parse_up_hosts(args.hosts) if args.hosts else []
    else:
        driver = "ssh"
        probe_hosts = parse_up_hosts(_hosts_from_args(args))
        cmds = [
            f"ssh {host} {shlex.quote(agent_cmd(host_port))}"
            for host, host_port in probe_hosts
        ]
    if execute and shutil.which(driver) is None:
        print(f"up: {driver!r} not found on PATH — printing commands "
              "instead (run them on the hosts yourself, or fix PATH)",
              file=sys.stderr)
        execute = False
    for cmd in cmds:
        print(cmd)
        if execute:
            rc = _run_shell(cmd)
            if rc != 0:
                print(f"up: driver exited {rc} for: {cmd}",
                      file=sys.stderr)
                return rc
    if not execute:
        if not args.dry_run:
            return 1  # driver missing — commands printed, but not up
        print("# dry run — rerun without --dry-run to execute",
              file=sys.stderr)
        return 0
    # Probe with the agents' key in scope: _probe_agent HMACs with it.
    # Plain assignment, not setdefault — an exported-but-EMPTY var must
    # not leave the probes on the default key while the agents run the
    # generated one. When the env was set non-empty, key equals it.
    os.environ["FIBER_CLUSTER_KEY"] = key
    if args.wait <= 0 and args.tpu and not probe_hosts:
        # Explicit opt-out, scoped to the derived-address path only
        # (an operator whose firewall drops the gcloud-derived probe
        # can still bring up). With --hosts, --wait 0 keeps its old
        # meaning: one immediate probe pass, nonzero if not live.
        print("up: agents started; verification SKIPPED by request "
              "(--wait 0) — agents are UNCONFIRMED", file=sys.stderr)
        return 0
    derived = False
    if not probe_hosts and args.tpu:
        # gcloud addresses workers by NAME; probing needs addresses.
        # Derive them from the pod itself so an `up` that confirmed
        # nothing can't return 0 (--hosts remains the override).
        try:
            probe_hosts = _derive_tpu_probe_hosts(
                args.tpu, args.zone, port)
            derived = True
        except RuntimeError as err:
            print(f"up: agents were started but could NOT be verified "
                  f"— worker address derivation failed ({err}); pass "
                  "--hosts ip[:port],... to probe them directly",
                  file=sys.stderr)
            return 1
    rc = _wait_for_agents(probe_hosts, args.wait)
    if rc == 0:
        hosts_str = ",".join(f"{h}:{p}" for h, p in probe_hosts)
        print(f"up: all agents live. Next:\n"
              f"  export FIBER_CLUSTER_KEY={key}\n"
              f"  FIBER_BACKEND=tpu FIBER_TPU_HOSTS={hosts_str} "
              "fiber-tpu run your_script.py")
    elif derived:
        print("up: note — the probed addresses came from gcloud "
              "describe (external IP first); a VPC firewall that "
              "drops the agent port from this machine fails this "
              "probe even when the agents are healthy. Probe from "
              "inside the VPC, pass --hosts with internal IPs, or "
              "use --wait 0 to skip verification explicitly.",
              file=sys.stderr)
    return rc


def cmd_down(args) -> int:
    """Stop the agents `up` started: the shutdown RPC over the data
    plane (no ssh round trip), per host. Agents terminate their live
    jobs first."""
    from fiber_tpu_torch.backends.tpu import AgentClient

    rc = 0
    for host, port in _resolve_cli_hosts(args):
        client = AgentClient(host, port)
        try:
            # Ping FIRST: connection-refused on a dead host must surface
            # as 'unreachable', not be swallowed as a mid-reply exit.
            client.call("ping")
            try:
                client.call("shutdown")
            except (EOFError, ConnectionError, OSError):
                pass  # agent exits mid-reply; that IS success
            print(f"down: {host}:{port} stopped")
        except Exception as err:  # noqa: BLE001
            print(f"down: {host}:{port} unreachable: {err!r}",
                  file=sys.stderr)
            rc = 1
        finally:
            try:
                client.close()
            except Exception:
                pass
    return rc


def _probe_agent(host: str, port: int):
    """Ping one agent; returns (host_info, live_jobs) or raises. The one
    probing routine status and doctor share."""
    from fiber_tpu_torch.backends.tpu import AgentClient

    client = AgentClient(host, port)
    try:
        client.call("ping")
        return client.call("host_info"), client.call("list_jobs")
    finally:
        client.close()


def _render_sched(snaps, indent: str = "  ") -> None:
    """Print scheduler-plane snapshots (docs/scheduling.md): per-pool
    queue depth and per-host in-flight chunk counts, beside the
    host_health/store_stats surfaces."""
    for s in snaps or []:
        print(f"{indent}sched policy={s.get('policy')} "
              f"queued={s.get('queued')} inflight={s.get('inflight')} "
              f"decisions={s.get('decisions')}")
        for hk, n in sorted((s.get("hosts") or {}).items()):
            print(f"{indent}  host {hk} inflight={n}")
        for mseq, depth in sorted((s.get("maps") or {}).items()):
            print(f"{indent}  map {mseq} queued={depth}")


def cmd_status(args) -> int:
    from fiber_tpu_torch.backends.tpu import AgentClient

    rc = 0
    rows = []
    for host, port in _resolve_cli_hosts(args):
        row = {"host": host, "port": port, "up": False}
        try:
            info, jobs = _probe_agent(host, port)
            row.update(up=True, cpus=info["cpu_count"],
                       live_jobs=len(jobs), python=info["python"])
            if not args.json:
                print(f"{host}:{port}  up  cpus={info['cpu_count']} "
                      f"live_jobs={len(jobs)} python={info['python']}")
        except Exception as err:
            row["error"] = repr(err)
            if not args.json:
                print(f"{host}:{port}  DOWN  ({err})")
            rc = 1
            rows.append(row)
            continue
        # Scheduler snapshot (best-effort: pre-sched agents and masters
        # without pools simply have none to show).
        client = AgentClient(host, port)
        try:
            snap = client.call("telemetry_snapshot")
            row["sched"] = snap.get("sched") or []
            if not args.json:
                _render_sched(snap.get("sched"), indent="    ")
        except Exception:  # noqa: BLE001
            pass
        finally:
            client.close()
        rows.append(row)
    if args.json:
        print(json.dumps(rows, default=str))
    return rc


#: The doctor's device probe: platform, device count and device 0's
#: name, as one JSON line (``torch.cuda.device_count()`` initializes no
#: CUDA context).
_CUDA_PROBE = (
    "import json, torch\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "print(json.dumps(['cuda' if n else 'cpu', n, "
    "torch.cuda.get_device_name(0) if n else None]))\n")


def _probe_cuda(timeout: float):
    """``doctor``'s CUDA line as ``(ok, detail)``: the platform, device
    count and device 0's name from a subprocess; a machine without a
    card reports ``platform=cpu count=0`` (host work needs none; device
    maps then need ``device="cpu"``)."""
    def probe(env):
        return subprocess.run([sys.executable, "-c", _CUDA_PROBE],
                              capture_output=True, text=True,
                              timeout=timeout, env=env)

    try:
        out = probe(dict(os.environ))
    except subprocess.TimeoutExpired:
        try:
            retried = probe(dict(os.environ, CUDA_VISIBLE_DEVICES="")
                            ).returncode == 0
        except subprocess.TimeoutExpired:
            retried = False
        if retried:
            return False, (f"probe hung >{timeout}s, but succeeded with "
                           "every card hidden (CUDA_VISIBLE_DEVICES=\"\") "
                           "— the CUDA driver is wedged; for host-only "
                           "work set CUDA_VISIBLE_DEVICES=\"\"")
        return False, (f"probe hung >{timeout}s even with every card "
                       "hidden (broken torch install?)")
    if out.returncode != 0:
        err = out.stderr.strip()
        return False, err.splitlines()[-1][:200] if err else "probe failed"
    try:
        platform, n, name = json.loads(out.stdout.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return False, "probe printed no answer"
    if not n:
        return True, ("platform=cpu count=0 (no CUDA device: device maps "
                      "need device=\"cpu\")")
    return True, f"platform={platform} count={n} device0={name}"


def cmd_doctor(args) -> int:
    """Diagnose the environment and (if hosts are known) the cluster:
    what backend would be selected and why, whether agents answer, key
    posture, the environment, and the CUDA devices a subprocess sees.
    Exit 0 = healthy; 1 = at least one FAIL line."""
    from fiber_tpu_torch import config

    rc = 0

    def line(ok, label, detail=""):
        nonlocal rc
        tag = "ok  " if ok else "FAIL"
        if not ok:
            rc = 1
        print(f"[{tag}] {label}" + (f": {detail}" if detail else ""))

    # 1. interpreter + config
    line(True, "python", sys.executable)
    cfg = config.get()
    line(True, "config", f"backend={cfg.backend or '(auto)'} "
                         f"tpu_hosts={cfg.tpu_hosts or '(unset)'} "
                         f"cpu_per_job={cfg.cpu_per_job} "
                         f"log_file={cfg.log_file}")

    # 2. backend selection (and whether a sniffed tpu would fall back)
    from fiber_tpu_torch.backends import _select_backend

    name, explicit = _select_backend()
    line(True, "backend selection",
         f"{name!r} ({'explicit' if explicit else 'sniffed'})")
    if not explicit and name == "tpu":
        print("       (sniffed: a reachability probe decides at first "
              "use; unreachable agents fall back to 'local')")

    # 3. env landmines
    injected = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    if injected:
        line(True, "TPU_WORKER_HOSTNAMES", injected)
    line(True, "CUDA_VISIBLE_DEVICES",
         os.environ.get("CUDA_VISIBLE_DEVICES", "(unset)"))

    # 4. CUDA devices, probed in a SUBPROCESS with a timeout so a wedged
    #    driver can't hang the doctor itself. A hang retries once with
    #    every card hidden (CUDA_VISIBLE_DEVICES="") to narrow the cause.
    ok, detail = _probe_cuda(float(args.timeout))
    line(ok, "cuda devices", detail)

    # 5. cluster key posture
    from fiber_tpu_torch import auth

    default_key = auth.cluster_key() == auth.DEFAULT_KEY.encode()
    line(True, "cluster key",
         "DEFAULT (development only — set FIBER_CLUSTER_KEY on real "
         "clusters)" if default_key else "custom (FIBER_CLUSTER_KEY)")

    # 6. agents (optional: no host list and no --tpu skips the section)
    hosts_spec = args.hosts or os.environ.get("FIBER_TPU_HOSTS", "")
    if hosts_spec.startswith("sim:"):
        print(f"[  --] agents: {hosts_spec} spawns local agents on "
              "demand — nothing standing to probe")
    elif hosts_spec or getattr(args, "tpu", ""):
        try:
            agent_hosts = _resolve_cli_hosts(args)
        except SystemExit as err:
            # doctor reports, it doesn't die: a failed gcloud
            # derivation is itself a diagnostic finding
            line(False, "agents", str(err))
            agent_hosts = []
        for host, port in agent_hosts:
            try:
                info, _ = _probe_agent(host, port)
                line(True, f"agent {host}:{port}",
                     f"cpus={info['cpu_count']} "
                     f"staging={info['staging_root']}")
            except Exception as err:
                line(False, f"agent {host}:{port}", str(err)[:120])
    else:
        print("[  --] agents: no host list (pass --hosts or set "
              "FIBER_TPU_HOSTS) — skipped")

    print("doctor:", "healthy" if rc == 0 else "problems found")
    return rc


def _fetch_snapshots(hosts):
    """One ``telemetry_snapshot`` sweep; returns ``(snaps, rc)``."""
    from fiber_tpu_torch.backends.tpu import AgentClient

    rc = 0
    snaps = {}
    for host, port in hosts:
        key = f"{host}:{port}"
        client = AgentClient(host, port)
        try:
            snaps[key] = client.call("telemetry_snapshot")
        except Exception as err:  # noqa: BLE001
            print(f"{key}  DOWN  ({err})", file=sys.stderr)
            rc = 1
        finally:
            client.close()
    return snaps, rc


def _metrics_watch(args, hosts) -> int:
    """``fiber-tpu metrics --watch <secs>``: poll consecutive snapshots
    and print what MOVED between them as deltas/rates (the timeseries
    plane's rate math — docs/observability.md "Continuous
    monitoring") instead of raw counter values."""
    from fiber_tpu_torch.telemetry.timeseries import snapshot_deltas

    interval = float(args.watch)
    rounds = int(args.count) if args.count else 0
    prev = {}
    prev_t = None
    n = 0
    rc = 0
    try:
        while True:
            snaps, poll_rc = _fetch_snapshots(hosts)
            rc = max(rc, poll_rc)
            now = time.monotonic()
            if prev_t is not None:
                dt = now - prev_t
                stamp = time.strftime("%H:%M:%S")
                print(f"-- {stamp}  (+{dt:.1f}s)")
                for key, snap in snaps.items():
                    deltas = snapshot_deltas(
                        (prev.get(key) or {}).get("metrics", {}),
                        snap.get("metrics", {}), dt)
                    if not deltas:
                        print(f"{key}  (no movement)")
                        continue
                    print(key)
                    for name, d in sorted(deltas.items()):
                        if d["kind"] == "gauge":
                            print(f"  {name} {d['value']:g} "
                                  f"({d['delta']:+g})")
                        else:
                            print(f"  {name} +{d['delta']:g} "
                                  f"({d['rate']:g}/s)")
            prev, prev_t = snaps, now
            n += 1
            if rounds and n > rounds:
                return rc
            time.sleep(interval)
    except KeyboardInterrupt:
        return rc


def cmd_metrics(args) -> int:
    """Fetch every host agent's telemetry snapshot and render it —
    human-readable counters by default, ``--prom`` for Prometheus
    v0.0.4 text exposition (host-labeled), ``--json`` for the raw
    snapshots, ``--watch <secs>`` to poll and print deltas/rates
    between consecutive snapshots (docs/observability.md)."""
    hosts = _resolve_cli_hosts(args)
    if args.watch > 0:
        return _metrics_watch(args, hosts)
    snaps, rc = _fetch_snapshots(hosts)
    if args.json:
        print(json.dumps(snaps, indent=2, default=str))
        return rc
    if args.prom:
        from fiber_tpu_torch.telemetry import merge_snapshots
        from fiber_tpu_torch.telemetry.export import prometheus_text

        merged = merge_snapshots(
            {k: s.get("metrics", {}) for k, s in snaps.items()})
        sys.stdout.write(prometheus_text(merged))
        return rc
    for key, snap in snaps.items():
        print(f"{key}  pid={snap.get('pid')} "
              f"enabled={snap.get('enabled')} "
              f"spans_buffered={snap.get('spans_buffered')}")
        for name, entry in sorted(snap.get("metrics", {}).items()):
            for labels, value in sorted(entry.get("series", {}).items()):
                if entry.get("type") == "histogram":
                    value = (f"count={value[-1]} "
                             f"sum={round(float(value[-2]), 6)}")
                rendered = f"{{{labels}}}" if labels else ""
                print(f"  {name}{rendered} {value}")
        for section, stat in sorted(snap.get("timers", {}).items()):
            print(f"  timer {section} count={stat[0]} total_s={stat[1]}")
        _render_sched(snap.get("sched"))
    return rc


def _render_hbm(device: dict) -> str:
    """HBM column: 'used/limit' when the host reports memory_stats; else
    the card's 'used/limit' as NVML reports it to a process without a
    CUDA context (``card_hbm``: every process's use), marked '*'; '-'
    honestly otherwise (CPU hosts, no device runtime)."""
    used = (device or {}).get("hbm_bytes_in_use")
    limit = (device or {}).get("hbm_bytes_limit")
    card = (device or {}).get("card_hbm")
    if used is None and limit is None and card:
        return _render_hbm({"hbm_bytes_in_use": card.get("bytes_in_use"),
                            "hbm_bytes_limit": card.get("bytes_limit")}
                           ) + "*"
    if used is None and limit is None:
        return "-"
    used_s = _human_bytes(used) if used is not None else "?"
    return f"{used_s}/{_human_bytes(limit)}" if limit else used_s


def _render_mfu(device: dict) -> str:
    mfu = (device or {}).get("mfu")
    return f"{float(mfu):.1%}" if mfu is not None else "-"


def _render_dstore(device: dict) -> str:
    """Device store tier occupancy: resident bytes, '!' suffix while the
    hbm_fill watchdog holds the tier demoted, '-' when the host never
    built a tier (disabled or no device work yet)."""
    n = (device or {}).get("dev_store_bytes")
    if n is None:
        return "-"
    mark = "!" if (device or {}).get("dev_store_demoted") else ""
    return f"{_human_bytes(n)}{mark}"


def _render_top_rows(pulls) -> list:
    """Monitor snapshots -> aligned table rows (one per host). Shared
    by cmd_top and its tests; anomaly flags come from each host's
    watchdog active set; HBM/MFU come from the device telemetry plane
    (rendered '-' when the host has no device runtime)."""
    rows = []
    for key in sorted(pulls):
        pull = pulls[key]
        if not isinstance(pull, dict) or "error" in pull:
            err = (pull or {}).get("error", "no data") \
                if isinstance(pull, dict) else "no data"
            rows.append(f"{key:<22} DOWN  ({str(err)[:60]})")
            continue
        last = (pull.get("timeseries") or {}).get("last") or {}
        anomalies = (pull.get("anomalies") or {}).get("active") or {}
        ages = pull.get("heartbeat_ages") or {}
        device = pull.get("device") or {}
        flags = ",".join(sorted(anomalies)) if anomalies else "-"
        rows.append(
            f"{key:<22} "
            f"{last.get('tasks_per_s', 0.0):>8.1f} "
            f"{int(last.get('inflight', 0)):>9d} "
            f"{int(last.get('queue_depth', 0)):>7d} "
            f"{_human_bytes(last.get('bytes_tx_per_s', 0.0)):>10}/s "
            f"{_human_bytes(last.get('bytes_rx_per_s', 0.0)):>10}/s "
            f"{max(ages.values(), default=0.0):>7.2f}s "
            f"{_render_hbm(device):>15} "
            f"{_render_dstore(device):>8} "
            f"{_render_mfu(device):>6} "
            f"{flags}")
    return rows


def _human_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KB", "MB", "GB"):
        if abs(n) < 1024.0 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n:.0f}B"
        n /= 1024.0
    return f"{n:.1f}GB"  # pragma: no cover - unreachable


_TOP_HEADER = (f"{'HOST':<22} {'EVALS/S':>8} {'INFLIGHT':>9} "
               f"{'QUEUE':>7} {'TX':>12} {'RX':>12} {'HB-AGE':>8} "
               f"{'HBM':>15} {'DSTORE':>8} {'MFU':>6} ANOMALIES")


def cmd_top(args) -> int:
    """``fiber-tpu top``: live auto-refreshing per-host table from the
    agents' continuous-monitor plane (docs/observability.md) — evals/s,
    in-flight tasks, queue depth, wire rates, heartbeat age and the
    anomaly watchdog's active flags. ``--iterations N`` renders N
    frames and exits (0 = until Ctrl-C); anomalies across hosts are
    merge-ordered on (wall, monotonic)."""
    from fiber_tpu_torch.backends.tpu import AgentClient
    from fiber_tpu_torch.telemetry.flightrec import order_events

    hosts = _resolve_cli_hosts(args)
    frames = 0
    rc = 0
    try:
        while True:
            pulls = {}
            costs = {}
            for host, port in hosts:
                key = f"{host}:{port}"
                client = AgentClient(host, port)
                try:
                    pulls[key] = client.call("monitor_snapshot",
                                             int(args.history))
                    if args.costs:
                        costs[key] = client.call("cost_snapshot")
                except Exception as err:  # noqa: BLE001
                    pulls[key] = {"error": repr(err)}
                    rc = 1
                finally:
                    client.close()
            if args.json:
                if args.costs:
                    for key in costs:
                        if isinstance(pulls.get(key), dict):
                            pulls[key]["costs"] = costs[key]
                print(json.dumps(pulls, default=str))
            else:
                if frames and not args.no_clear:
                    sys.stdout.write("\x1b[2J\x1b[H")
                print(f"fiber-tpu top — {len(hosts)} host(s) — "
                      f"{time.strftime('%H:%M:%S')}")
                print(_TOP_HEADER)
                for row in _render_top_rows(pulls):
                    print(row)
                # Recent anomalies, newest last, merged across hosts on
                # the wall clock with the monotonic tiebreak.
                recent = []
                for key, pull in pulls.items():
                    if not isinstance(pull, dict):
                        continue
                    for rec in ((pull.get("anomalies") or {})
                                .get("recent") or []):
                        rec = dict(rec)
                        rec.setdefault("ts", rec.get("wall", 0.0))
                        rec["host"] = key
                        recent.append(rec)
                for rec in order_events(recent)[-args.last:]:
                    stamp = time.strftime(
                        "%H:%M:%S", time.localtime(rec.get("wall", 0)))
                    print(f"  [{stamp}] {rec['host']} "
                          f"{rec.get('rule')}: {rec.get('detail')}")
                # Recent policy actions (autonomous operations), same
                # merge order; the glyph is the verified outcome:
                # + resolved, ~ persisted, ! worsened, ? pending.
                acted = []
                for key, pull in pulls.items():
                    if not isinstance(pull, dict):
                        continue
                    for act in pull.get("policy") or []:
                        act = dict(act)
                        act.setdefault("ts", act.get("wall", 0.0))
                        act["host"] = key
                        acted.append(act)
                glyphs = {"resolved": "+", "persisted": "~",
                          "worsened": "!"}
                for act in order_events(acted)[-args.last:]:
                    stamp = time.strftime(
                        "%H:%M:%S", time.localtime(act.get("wall", 0)))
                    g = glyphs.get(act.get("outcome"), "?")
                    print(f"  [{stamp}] {act['host']} policy "
                          f"{act.get('action')} <- {act.get('rule')} "
                          f"[{g}]")
                if args.costs:
                    print("costs (per billing key, top by cpu_s):")
                    for row in _render_cost_rows(costs, args.last):
                        print(row)
                if getattr(args, "serve", ""):
                    # Serving-tier daemon state (docs/serving.md): job
                    # counts by state, warm-pool size and admission
                    # denials from the daemon's status verb.
                    from fiber_tpu_torch.serve.client import ServeClient

                    sc = ServeClient(_serve_address(args.serve))
                    try:
                        st = sc.status()
                        jobs_s = " ".join(
                            f"{k}={v}" for k, v in sorted(
                                (st.get("jobs") or {}).items())) or "none"
                        warm = st.get("warm_pool") or {}
                        adm = st.get("admission") or {}
                        print(f"serve: pid={st.get('pid')} "
                              f"up={st.get('uptime_s', 0.0):.0f}s "
                              f"jobs[{jobs_s}] "
                              f"workers={warm.get('workers')}"
                              f"/{warm.get('floor')}-{warm.get('ceiling')} "
                              f"denied={sum((adm.get('denied') or {}).values())} "
                              f"preempted={adm.get('preempted_maps', 0)}")
                        # SLO/burn + archive columns:
                        # aggregate error rate / p95 / worst fast-window
                        # burn, and the durable archive's size — older
                        # daemons without the fields just skip the row.
                        slo = st.get("slo") or {}
                        arch = st.get("archive") or {}
                        if slo:
                            err_rate = slo.get("error_rate")
                            p95 = slo.get("latency_p95")
                            burn = slo.get("max_burn")
                            err_s = (f"{err_rate:.1%}"
                                     if err_rate is not None else "-")
                            p95_s = f"{p95}s" if p95 is not None else "-"
                            burn_s = (f"{burn}x"
                                      if burn is not None else "-")
                            flag = ("BURN" if slo.get("breached")
                                    else "ok")
                            print(f"serve slo: {flag} "
                                  f"jobs={slo.get('window_jobs', 0)} "
                                  f"err={err_s} p95={p95_s} "
                                  f"burn={burn_s}  "
                                  f"archive[segs={arch.get('segments', 0)} "
                                  f"{int(arch.get('bytes', 0)) >> 10}KB "
                                  f"torn={arch.get('torn_lines', 0)}]")
                    except Exception as err:  # noqa: BLE001
                        print(f"serve: unreachable ({err!r})")
                        rc = 1
                    finally:
                        sc.close()
                sys.stdout.flush()
            frames += 1
            if args.iterations and frames >= args.iterations:
                return rc
            time.sleep(float(args.interval))
    except KeyboardInterrupt:
        return rc


def _render_cost_rows(costs: dict, last: int = 8) -> list:
    """Cost snapshots -> aligned rows (accounting plane, `fiber-tpu top
    --costs`): per host, the top billing keys by worker busy-seconds,
    with the overhead bucket shown explicitly."""
    rows = []
    for hkey in sorted(costs):
        snap = costs[hkey]
        table = (snap or {}).get("costs") or {}
        ranked = sorted(
            table.items(),
            key=lambda kv: kv[1].get("cpu_s", 0.0)
            + kv[1].get("wall_s", 0.0),
            reverse=True)[:max(1, int(last))]
        for kstr, vec in ranked:
            rows.append(
                f"  {hkey:<22} {kstr:<32} "
                f"tasks={int(vec.get('tasks', 0)):>6} "
                f"cpu={vec.get('cpu_s', 0.0):>8.2f}s "
                f"wire={_human_bytes(vec.get('wire_tx', 0.0) + vec.get('wire_rx', 0.0)):>10} "
                f"dev={vec.get('device_s', 0.0):>6.2f}s")
        if not ranked:
            rows.append(f"  {hkey:<22} (no billed keys)")
    return rows


def _render_device_rows(pulls) -> list:
    """Device snapshots -> aligned table rows (one per host). Shared by
    cmd_devices and its tests; null HBM/MFU render '-' honestly."""
    rows = []
    for key in sorted(pulls):
        snap = pulls[key]
        if not isinstance(snap, dict) or "error" in snap:
            err = (snap or {}).get("error", "no data") \
                if isinstance(snap, dict) else "no data"
            rows.append(f"{key:<22} DOWN  ({str(err)[:60]})")
            continue
        hbm = snap.get("hbm") or {}
        mfu = (snap.get("mfu") or {}).get("mfu")
        live = snap.get("live_arrays") or {}
        storm = (snap.get("recompile") or {}).get("storm")
        rows.append(
            f"{key:<22} "
            f"{str(snap.get('platform') or '-'):>8} "
            f"{_human_bytes(snap.get('transfer_bytes', 0)):>10} "
            f"{float(snap.get('transfer_seconds', 0.0)):>9.3f}s "
            f"{int(snap.get('compiles', 0)):>8d} "
            f"{float(snap.get('compile_seconds', 0.0)):>9.3f}s "
            f"{_render_hbm({'hbm_bytes_in_use': hbm.get('bytes_in_use'), 'hbm_bytes_limit': hbm.get('bytes_limit'), 'card_hbm': snap.get('card_hbm')}):>15} "
            f"{(str(live.get('count')) if live.get('count') is not None else '-'):>7} "
            f"{_render_mfu({'mfu': mfu}):>6} "
            f"{'STORM' if storm else '-'}")
    return rows


_DEVICES_HEADER = (f"{'HOST':<22} {'PLATFORM':>8} {'XFER-B':>10} "
                   f"{'XFER-S':>10} {'COMPILES':>8} {'COMPILE-S':>10} "
                   f"{'HBM':>15} {'ARRAYS':>7} {'MFU':>6} RECOMPILE")


def cmd_devices(args) -> int:
    """``fiber-tpu devices``: per-host device telemetry — transfer
    bytes/seconds, compile count/seconds, HBM and live-array stats
    (honest '-' on hosts without a device runtime), recompile-storm
    state and the last live MFU (docs/observability.md "Device
    telemetry"). ``--json`` ships the raw per-host snapshots."""
    from fiber_tpu_torch.backends.tpu import AgentClient

    hosts = _resolve_cli_hosts(args)
    rc = 0
    pulls = {}
    for host, port in hosts:
        key = f"{host}:{port}"
        client = AgentClient(host, port)
        try:
            pulls[key] = client.call("device_snapshot")
        except Exception as err:  # noqa: BLE001
            pulls[key] = {"error": repr(err)}
            rc = 1
        finally:
            client.close()
    if args.json:
        print(json.dumps(pulls, default=str))
        return rc
    print(_DEVICES_HEADER)
    for row in _render_device_rows(pulls):
        print(row)
    if args.sites:
        for key, snap in sorted(pulls.items()):
            if not isinstance(snap, dict) or "error" in snap:
                continue
            for site, agg in sorted(
                    (snap.get("transfers") or {}).items()):
                print(f"  {key} {site:<16} "
                      f"n={agg.get('count', 0)} "
                      f"{_human_bytes(agg.get('bytes', 0))} "
                      f"{float(agg.get('seconds', 0.0)):.4f}s")
    return rc


def cmd_profile(args) -> int:
    """``fiber-tpu profile``: wall-clock sampling profiles as
    flamegraph folded output (docs/observability.md "Sampling
    profiler"). Two modes:

    * ``fiber-tpu profile script.py [args…] --out prof.folded`` — run
      the script with the profiler armed in this process AND every
      fiber_tpu_torch worker it spawns (the workers' stacks ship back on the
      result stream); the merged cluster profile lands in --out.
    * ``fiber-tpu profile --hosts … --out prof.folded`` — no script:
      pull an on-demand burst profile from every host agent.
    """
    from fiber_tpu_torch.telemetry import profiler as profmod

    hz = float(args.hz)
    if hz <= 0:
        raise SystemExit("error: --hz must be > 0")
    if not args.script:
        if not (args.hosts or getattr(args, "tpu", "")):
            raise SystemExit(
                "error: pass a script to profile, or --hosts to pull "
                "agent profiles")
        from fiber_tpu_torch.backends.tpu import AgentClient

        rc = 0
        merged: dict = {}
        for host, port in _resolve_cli_hosts(args):
            key = f"{host}:{port}"
            client = AgentClient(host, port)
            try:
                pull = client.call("profile_dump", float(args.seconds), hz)
            except Exception as err:  # noqa: BLE001
                print(f"{key}  DOWN  ({err})", file=sys.stderr)
                rc = 1
                continue
            finally:
                client.close()
            # Host-prefix each stack so the merged flamegraph keeps
            # per-host attribution as its root frames.
            for stack, count in (pull.get("folded") or {}).items():
                pre = f"host:{key};{stack}"
                merged[pre] = merged.get(pre, 0) + count
        _write_profile(args, merged, hz)
        return rc
    # Script mode: arm the profiler via the config env so this process
    # and every spawned worker inherit it (config ships in spawn prep).
    os.environ["FIBER_PROFILER_HZ"] = str(hz)
    import fiber_tpu_torch

    fiber_tpu_torch.init()
    try:
        _run_script(args.script, args.script_args)
    except SystemExit as err:
        if err.code not in (0, None):
            print(f"profile: script exited {err.code}", file=sys.stderr)
    finally:
        profmod.PROFILER.set_hz(0.0)
    merged = profmod.merge_folded(profmod.PROFILER.snapshot(),
                                  profmod.AGGREGATE.merged())
    _write_profile(args, merged, hz)
    return 0


def _write_profile(args, folded: dict, hz: float) -> None:
    from fiber_tpu_torch.telemetry import profiler as profmod

    out = args.out or "prof.folded"
    with open(out, "w") as fh:
        fh.write(profmod.folded_text(folded))
    samples = sum(folded.values())
    print(f"profile: {samples} sample(s), {len(folded)} stack(s) "
          f"-> {out}", file=sys.stderr)
    if args.chrome:
        profmod.write_chrome_profile(args.chrome, folded, hz)
        print(f"profile: chrome flame view -> {args.chrome}",
              file=sys.stderr)


def cmd_explain(args) -> int:
    """Join a trace artifact (``Pool.trace_dump`` Chrome JSON or a raw
    span list) with flight events (``Pool.flight_dump``) and print the
    ranked blame budget (docs/observability.md)."""
    from fiber_tpu_torch.telemetry import explain as explainmod

    try:
        spans = explainmod.load_spans(args.trace)
    except (OSError, ValueError) as err:
        raise SystemExit(f"error: cannot load trace: {err}") from None
    events = []
    log_tail = []
    if args.flight:
        try:
            events = explainmod.load_events(args.flight)
        except (OSError, ValueError) as err:
            raise SystemExit(
                f"error: cannot load flight events: {err}") from None
        # The artifact's log-ring tail (logs pillar): rendered next to
        # the blamed events so the operator sees what the process was
        # logging, not just what its planes decided.
        log_tail = explainmod.load_logs(args.flight)
    profile = None
    if getattr(args, "profile", ""):
        from fiber_tpu_torch.telemetry import profiler as profmod

        try:
            profile = profmod.load_folded(args.profile)
        except (OSError, ValueError) as err:
            raise SystemExit(
                f"error: cannot load profile: {err}") from None
    try:
        verdict = explainmod.explain_trace(
            spans, events, trace_id=args.trace_id or None,
            quantile=args.quantile, profile=profile)
    except ValueError as err:
        raise SystemExit(f"error: {err}") from None
    # Autonomous-operations narration (docs/observability.md): with a
    # flight artifact, the anomaly -> action -> outcome chains the
    # policy plane recorded ride beside the blame budget.
    chains = explainmod.policy_chains(events) if events else []
    if args.json:
        if log_tail:
            verdict = dict(verdict, log_tail=log_tail)
        if events:
            verdict = dict(verdict, policy_chains=chains)
        print(json.dumps(verdict))
    else:
        print(explainmod.render(verdict))
        if chains:
            print(explainmod.render_chains(chains))
        if log_tail:
            print("recent log tail (flight artifact):")
            for line in log_tail:
                print(f"  {line}")
    return 0


def cmd_policies(args) -> int:
    """``fiber-tpu policies``: the autonomous-operations surface
    (docs/observability.md "Autonomous operations"). Default: this
    process's policy table + recent actions. ``--hosts`` pulls each
    agent's recent actions instead; ``--flight`` narrates the
    anomaly -> action -> outcome chains of a recorded artifact."""
    from fiber_tpu_torch.telemetry import explain as explainmod
    from fiber_tpu_torch.telemetry.policy import POLICY

    glyphs = {"resolved": "+", "persisted": "~", "worsened": "!"}

    def action_line(act: dict, host: str = "") -> str:
        stamp = time.strftime("%H:%M:%S",
                              time.localtime(act.get("wall", 0)))
        g = glyphs.get(act.get("outcome"), "?")
        mode = ("dry-run" if act.get("dry_run")
                else ("applied" if act.get("applied") else "no-op"))
        where = f"{host} " if host else ""
        return (f"  [{stamp}] {where}{act.get('rule')} -> "
                f"{act.get('action')} ({mode}) [{g}] "
                f"{act.get('detail', '')}")

    if getattr(args, "flight", ""):
        try:
            events = explainmod.load_events(args.flight)
        except (OSError, ValueError) as err:
            raise SystemExit(
                f"error: cannot load flight events: {err}") from None
        chains = explainmod.policy_chains(events)
        if args.json:
            print(json.dumps({"policy_chains": chains}, default=str))
        else:
            print(explainmod.render_chains(chains))
        return 0

    if args.hosts or getattr(args, "tpu", ""):
        from fiber_tpu_torch.backends.tpu import AgentClient
        from fiber_tpu_torch.telemetry.flightrec import order_events

        rc = 0
        pulls = {}
        for host, port in _resolve_cli_hosts(args):
            key = f"{host}:{port}"
            client = AgentClient(host, port)
            try:
                pulls[key] = client.call("monitor_snapshot", 1)
            except Exception as err:  # noqa: BLE001
                pulls[key] = {"error": repr(err)}
                rc = 1
            finally:
                client.close()
        if args.json:
            print(json.dumps(
                {k: (p.get("policy") if isinstance(p, dict) else p)
                 for k, p in pulls.items()}, default=str))
            return rc
        acted = []
        for key, pull in pulls.items():
            if not isinstance(pull, dict) or "error" in pull:
                print(f"{key}  DOWN  "
                      f"({(pull or {}).get('error', 'no payload')})")
                continue
            for act in pull.get("policy") or []:
                act = dict(act)
                act.setdefault("ts", act.get("wall", 0.0))
                act["host"] = key
                acted.append(act)
        print(f"recent policy actions across {len(pulls)} host(s) "
              "(+ resolved, ~ persisted, ! worsened, ? pending):")
        ordered = order_events(acted)[-args.last:]
        if not ordered:
            print("  (none)")
        for act in ordered:
            print(action_line(act, host=act["host"]))
        return rc

    snap = POLICY.snapshot()
    if args.json:
        print(json.dumps(snap, default=str))
        return 0
    state = "enabled" if snap["enabled"] else "disabled"
    if snap["enabled"] and snap["dry_run"]:
        state += " (dry-run)"
    print(f"policy engine: {state}  cooldown={snap['cooldown_s']:g}s  "
          f"verify={snap['verify_s']:g}s  rules={snap['rules']}")
    print(f"{'RULE':<18} {'ACTION':<22} {'COOLDOWN':>9}  KNOB")
    for pol in snap["policies"]:
        print(f"{pol['rule']:<18} {pol['action']:<22} "
              f"{pol['cooldown_s']:>8g}s  {pol['knob']}")
    print(f"actions={snap['actions_total']} "
          f"suppressed={snap['suppressed_total']} "
          f"pending_verifications={snap['pending_verifications']}")
    recent = snap["recent"][-args.last:]
    if recent:
        print("recent actions (+ resolved, ~ persisted, ! worsened, "
              "? pending):")
        for act in recent:
            print(action_line(act))
    return 0


def cmd_postmortem(args) -> int:
    """Black-box bundles: with ``--hosts``/``--tpu``, pull each agent's
    ``postmortem`` op (its flight buffer, stack dump, and the crash
    bundles workers there flushed); without, list the bundles under the
    local staging root (or ``--dir``)."""
    from fiber_tpu_torch.telemetry import postmortem

    def describe(bundle: dict) -> str:
        flight = bundle.get("flight") or []
        return (f"reason={bundle.get('reason')} "
                f"host={bundle.get('host')} pid={bundle.get('pid')} "
                f"ident={bundle.get('ident', '-')} "
                f"flight_events={len(flight)} "
                f"stacks={'yes' if bundle.get('stacks') else 'no'}")

    if args.hosts or getattr(args, "tpu", ""):
        from fiber_tpu_torch.backends.tpu import AgentClient

        rc = 0
        pulls = {}
        for host, port in _resolve_cli_hosts(args):
            key = f"{host}:{port}"
            client = AgentClient(host, port)
            try:
                pulls[key] = client.call("postmortem")
            except Exception as err:  # noqa: BLE001
                print(f"{key}  DOWN  ({err})", file=sys.stderr)
                rc = 1
            finally:
                client.close()
        if args.json:
            print(json.dumps(pulls, default=str))
            return rc
        for key, pull in pulls.items():
            bundles = pull.get("bundles") or []
            print(f"{key}  agent pid={pull.get('pid')} "
                  f"flight_events={len(pull.get('flight') or [])} "
                  f"bundles={len(bundles)}")
            for bundle in bundles[-args.last:]:
                print(f"  {describe(bundle)}")
        return rc

    directory = args.dir or postmortem.bundle_dir()
    paths = postmortem.list_bundles(directory)
    if args.json:
        out = []
        for path in paths[-args.last:]:
            try:
                out.append(postmortem.read_bundle(path))
            except (OSError, ValueError):
                continue
        print(json.dumps(out, default=str))
        return 0
    if not paths:
        print(f"no postmortem bundles under {directory}")
        return 0
    for path in paths[-args.last:]:
        try:
            bundle = postmortem.read_bundle(path)
        except (OSError, ValueError) as err:
            print(f"{path}  unreadable ({err})", file=sys.stderr)
            continue
        print(f"{path}\n  {describe(bundle)}")
    return 0


def cmd_cost(args) -> int:
    """``fiber-tpu cost <job_id>``: render one job's CostReport
    (docs/observability.md "Resource accounting") — the record a
    completed ``Pool.map(..., job_id=...)`` persisted beside its
    ledger, or, with ``--hosts``, the live per-host cost ledgers
    filtered to the job's billing keys."""
    from fiber_tpu_torch.telemetry import accounting

    if args.hosts or getattr(args, "tpu", ""):
        from fiber_tpu_torch.backends.tpu import AgentClient

        rc = 0
        pulls = {}
        for host, port in _resolve_cli_hosts(args):
            key = f"{host}:{port}"
            client = AgentClient(host, port)
            try:
                pulls[key] = client.call("cost_snapshot")
            except Exception as err:  # noqa: BLE001
                print(f"{key}  DOWN  ({err})", file=sys.stderr)
                rc = 1
            finally:
                client.close()
        if args.json:
            print(json.dumps(pulls, default=str))
            return rc
        for hkey, snap in sorted(pulls.items()):
            rows = [(kstr, vec) for kstr, vec
                    in sorted((snap.get("costs") or {}).items())
                    if accounting.parse_key(kstr)[1] == args.job_id]
            print(f"{hkey}  pid={snap.get('pid')} "
                  f"matching_keys={len(rows)}")
            for kstr, vec in rows:
                bits = " ".join(f"{f}={round(v, 4):g}"
                                for f, v in sorted(vec.items()))
                print(f"  {kstr}  {bits}")
        return rc
    record = accounting.read_job_record(args.job_id, args.dir or None)
    if record is None:
        raise SystemExit(
            f"error: no cost record for job {args.job_id!r} under "
            f"{args.dir or accounting.cost_dir()} (records are written "
            "when a map submitted with job_id= completes)")
    if args.json:
        print(json.dumps(record, default=str))
        return 0
    print(accounting.render_report(record))
    return 0


def cmd_resume(args) -> int:
    """Resume one durable map from its write-ahead ledger
    (docs/robustness.md): reconstruct the call from the journaled spec
    payload, restore every completed chunk's results by digest (master
    disk first, then the per-host caches), and re-execute ONLY the
    remainder — exactly one result per task, proven by the printed
    restored/executed split. Run with the same backend environment
    (FIBER_BACKEND / FIBER_TPU_HOSTS / FIBER_CLUSTER_KEY) as the
    crashed master."""
    import fiber_tpu_torch
    from fiber_tpu_torch import serialization
    from fiber_tpu_torch import store as storemod
    from fiber_tpu_torch.store import ledger as ledgermod

    try:
        path = ledgermod.job_path(args.job_id, args.ledger_dir or None)
    except ValueError as err:
        raise SystemExit(f"error: {err}") from None
    if not os.path.exists(path):
        known = ledgermod.list_jobs(args.ledger_dir or None)
        hint = f" (known jobs: {', '.join(known)})" if known else ""
        raise SystemExit(
            f"error: no ledger for job {args.job_id!r} at {path}{hint}")
    try:
        header, completed, done = ledgermod.load(path)
    except (OSError, ValueError) as err:
        raise SystemExit(f"error: cannot load ledger: {err}") from None
    if header.get("kind") == "stream":
        return _resume_stream(args, path)
    spec_digest = header.get("spec")
    if not spec_digest:
        raise SystemExit(
            "error: this ledger carries no resumable spec payload; "
            "resume by re-calling Pool.map(..., job_id=...) from the "
            "original script")
    data = storemod.local_store().get_bytes(spec_digest)
    if data is None:
        from fiber_tpu_torch.backends import get_backend

        fetch = getattr(get_backend(), "fetch_object", None)
        data = fetch(spec_digest) if fetch is not None else None
    if data is None:
        raise SystemExit(
            f"error: spec payload {spec_digest[:12]} not found in any "
            "store tier; resume from the original script instead")
    try:
        func_blob, items, star, chunksize = serialization.loads(data)
        func = serialization.loads(func_blob)
    except Exception as err:  # noqa: BLE001
        raise SystemExit(
            f"error: spec payload did not deserialize: {err}") from None
    print(f"resume: job {args.job_id!r} — {len(items)} tasks, "
          f"{len(completed)} chunk(s) already journaled"
          + (" (ledger already complete)" if done else ""),
          file=sys.stderr)
    with fiber_tpu_torch.Pool(args.processes or None) as pool:
        if star:
            results = pool.starmap(func, items, chunksize=chunksize,
                                   job_id=args.job_id)
        else:
            results = pool.map(func, items, chunksize=chunksize,
                               job_id=args.job_id)
        info = pool.ledger_stats()
    summary = {
        "job_id": args.job_id,
        "tasks": len(results),
        "restored_tasks": int(info.get("restored_tasks") or 0),
        "executed_tasks": len(results) - int(
            info.get("restored_tasks") or 0),
        "restored_chunks": int(info.get("restored_chunks") or 0),
        "chunks": int(info.get("chunks") or 0),
        "trace": info.get("trace"),
    }
    if args.out:
        with open(args.out, "wb") as fh:
            fh.write(serialization.dumps(results))
        summary["out"] = args.out
    print(json.dumps(summary))
    return 0


def _stream_payload(digest: str):
    """Fetch one journaled payload by digest: master disk tier first,
    then the per-host caches via the backend (the replication hook
    registers stream admits/results as precious)."""
    from fiber_tpu_torch import store as storemod

    data = storemod.local_store().get_bytes(digest)
    if data is None:
        from fiber_tpu_torch.backends import get_backend

        fetch = getattr(get_backend(), "fetch_object", None)
        if fetch is not None:
            try:
                data = fetch(digest)
            except Exception:  # noqa: BLE001 - fall through to None
                data = None
    return data


def _resume_stream(args, path: str) -> int:
    """Resume a half-consumed STREAM ledger (docs/streaming.md):
    restore every journaled result chunk by digest, re-execute
    admitted-but-unjournaled chunks from their journaled input payloads
    (the producer iterator died with the master — the admit records are
    the only copy), journal the new results into the same ledger, and
    emit the unconsumed suffix (everything past the journaled consumer
    cursor) to ``--out``. Items the dead master never ADMITTED are
    unrecoverable by construction; the summary reports the admitted
    frontier rather than pretending to know the stream's full length."""
    import fiber_tpu_torch
    from fiber_tpu_torch import serialization
    from fiber_tpu_torch.store import ledger as ledgermod

    try:
        header, admits, completed, cursor, done = \
            ledgermod.load_stream(path)
    except (OSError, ValueError) as err:
        raise SystemExit(
            f"error: cannot load stream ledger: {err}") from None
    spec_digest = header.get("spec")
    if not spec_digest:
        raise SystemExit(
            "error: this stream ledger carries no resumable spec "
            "payload; resume by re-calling Pool.imap(..., job_id=...) "
            "from the original script")
    data = _stream_payload(spec_digest)
    if data is None:
        raise SystemExit(
            f"error: spec payload {str(spec_digest)[:12]} not found in "
            "any store tier; resume from the original script instead")
    try:
        func_blob, star, chunksize = serialization.loads(data)
        func = serialization.loads(func_blob)
    except Exception as err:  # noqa: BLE001
        raise SystemExit(
            f"error: stream spec did not deserialize: {err}") from None
    bases = sorted(admits)
    n_admitted = sum(admits[b][0] for b in bases)
    pending = [b for b in bases if b not in completed]
    print(f"resume: stream job {args.job_id!r} — {n_admitted} admitted "
          f"task(s) in {len(bases)} chunk(s), {len(completed)} result "
          f"chunk(s) journaled, cursor at {cursor}"
          + (" (ledger already complete)" if done else ""),
          file=sys.stderr)
    values_by_base = {}
    restored_tasks = 0
    for b in bases:
        if b not in completed:
            continue
        n, digest = completed[b]
        payload = _stream_payload(digest)
        vals = None
        if payload is not None:
            try:
                vals = serialization.loads(payload)
            except Exception:  # noqa: BLE001 - corrupt == lost
                vals = None
        if isinstance(vals, list) and len(vals) == n:
            values_by_base[b] = vals
            restored_tasks += n
        else:
            # Result payload lost: degrade that chunk to re-execution
            # from its admit payload (tasks are idempotent).
            pending.append(b)
    pending = sorted(set(pending))
    pending_items = []
    spans = []  # (base, start, n) slices into the re-executed batch
    for b in pending:
        n, digest = admits[b]
        payload = _stream_payload(digest)
        items = None
        if payload is not None:
            try:
                items = serialization.loads(payload)
            except Exception:  # noqa: BLE001
                items = None
        if not isinstance(items, list) or len(items) != n:
            raise SystemExit(
                f"error: admit payload for chunk base={b} not found in "
                "any store tier; the stream cannot be resumed "
                "losslessly")
        spans.append((b, len(pending_items), n))
        pending_items.extend(items)
    executed_tasks = len(pending_items)
    led = None
    if pending_items:
        store = storemod_local_for_ledger()
        led = ledgermod.MapLedger(path, store)
        led.adopt(completed)
        led.adopt_admits(admits)
        with fiber_tpu_torch.Pool(args.processes or None) as pool:
            if star:
                out = pool.starmap(func, pending_items,
                                   chunksize=chunksize)
            else:
                out = pool.map(func, pending_items, chunksize=chunksize)
        for b, start, n in spans:
            vals = out[start:start + n]
            values_by_base[b] = vals
            led.record_chunk(b, n, vals)
    flat = []
    for b in bases:
        flat.extend(values_by_base[b])
    if led is not None:
        if not done:
            led.record_done()
        led.flush()
        led.close()
    summary = {
        "job_id": args.job_id, "kind": "stream",
        "tasks": n_admitted,
        "restored_tasks": restored_tasks,
        "executed_tasks": executed_tasks,
        "restored_chunks": len(bases) - len(spans),
        "chunks": len(bases),
        "consumed": cursor,
        "emitted": max(0, len(flat) - cursor),
        "trace": header.get("trace"),
    }
    if args.out:
        with open(args.out, "wb") as fh:
            fh.write(serialization.dumps(flat[cursor:]))
        summary["out"] = args.out
    print(json.dumps(summary))
    return 0


def storemod_local_for_ledger():
    """The store instance stream-resume journals through (factored so
    tests can see exactly which tier the payloads land in)."""
    from fiber_tpu_torch import store as storemod

    return storemod.local_store()


def cmd_jobs(args) -> int:
    """List durable-map ledgers (job id, tenant, chunk counts, done
    flag). ``--tenant`` filters on the tenant column, which is sourced
    from the accounting plane's persisted per-job cost records
    (``<staging>/costs/<job>.json``) — a job with no record yet (still
    running, or accounting disabled) shows ``-`` and survives the
    filter only when no filter is set."""
    from fiber_tpu_torch.store import ledger as ledgermod
    from fiber_tpu_torch.telemetry import accounting

    as_json = bool(getattr(args, "json", False))
    jobs = ledgermod.list_jobs(args.ledger_dir or None)
    if not jobs:
        if as_json:
            print("[]")
        else:
            print("no job ledgers under "
                  f"{args.ledger_dir or ledgermod.default_ledger_dir()}")
        return 0
    shown = 0
    rows = []
    for job in jobs:
        try:
            header, completed, done = ledgermod.load(
                ledgermod.job_path(job, args.ledger_dir or None))
        except (OSError, ValueError) as err:
            print(f"{job}  unreadable ({err})", file=sys.stderr)
            continue
        # Historical cost (accounting plane): the record a completed
        # run persisted beside this ledger, when one exists. Its tenant
        # field is the serve tier's billing identity for the job.
        record = accounting.read_job_record(job)
        tenant = (record or {}).get("tenant")
        want = getattr(args, "tenant", "") or ""
        if want and tenant != want:
            continue
        n_items = int(header.get("n_items") or 0)
        if as_json:
            rows.append({
                "job_id": job, "tenant": tenant, "tasks": n_items,
                "journaled_chunks": len(completed), "done": done,
                "cost": (record or {}).get("total"),
                "ts": (record or {}).get("ts"),
            })
            shown += 1
            continue
        line = (f"{job}  tenant={tenant or '-'} tasks={n_items} "
                f"journaled_chunks={len(completed)} "
                f"{'done' if done else 'RESUMABLE'}")
        if record is not None:
            total = record.get("total") or {}
            line += (f"  cost: cpu={total.get('cpu_s', 0.0):.2f}s "
                     f"wire={int(total.get('wire_tx', 0) + total.get('wire_rx', 0))}B "
                     f"tasks={int(total.get('tasks', 0))}"
                     f"+{int(total.get('tasks_restored', 0))}r")
        print(line)
        shown += 1
    if as_json:
        print(json.dumps(rows, default=str))
    elif not shown and getattr(args, "tenant", ""):
        print(f"no jobs billed to tenant {args.tenant!r}")
    return 0


def _serve_address(text: str):
    """Parse ``host:port`` / ``:port`` / ``port`` into an address tuple
    (default host 127.0.0.1, default port from config serve_port)."""
    from fiber_tpu_torch import config as _config

    host, port = "127.0.0.1", int(_config.get().serve_port)
    text = (text or "").strip()
    if text:
        if ":" in text:
            h, _, p = text.rpartition(":")
            host = h or host
            port = int(p)
        elif text.isdigit():
            port = int(text)
        else:
            host = text
    return host, port


def cmd_serve(args) -> int:
    """Run the long-lived multi-tenant serving daemon
    (docs/serving.md)."""
    from fiber_tpu_torch.serve import daemon as servemod

    argv = []
    if args.backend:
        argv += ["--backend", args.backend]
    if args.port:
        argv += ["--port", str(args.port)]
    if args.bind:
        argv += ["--bind", args.bind]
    if args.processes:
        argv += ["--processes", str(args.processes)]
    return servemod.main(argv)


def cmd_submit(args) -> int:
    """Submit one job to a running serve daemon and (optionally) wait:
    the function is ``module:function``, the items a JSON list."""
    import importlib

    from fiber_tpu_torch.serve.client import ServeClient, ServeError

    if ":" not in args.func:
        raise SystemExit("error: func must look like module:function")
    mod_name, _, fn_name = args.func.partition(":")
    sys.path.insert(0, os.getcwd())
    try:
        fn = getattr(importlib.import_module(mod_name), fn_name)
    except (ImportError, AttributeError) as err:
        raise SystemExit(f"error: cannot load {args.func!r}: {err}") \
            from None
    try:
        items = json.loads(args.items)
    except ValueError as err:
        raise SystemExit(f"error: --items is not JSON: {err}") from None
    if not isinstance(items, list):
        raise SystemExit("error: --items must be a JSON list")
    budget = None
    if args.budget:
        try:
            budget = json.loads(args.budget)
        except ValueError as err:
            raise SystemExit(
                f"error: --budget is not JSON: {err}") from None
    client = ServeClient(_serve_address(args.serve))
    try:
        job_id = client.submit(fn, items, tenant=args.tenant,
                               job_id=args.job_id or None,
                               star=args.star,
                               chunksize=args.chunksize or None,
                               budget=budget)
        if not args.wait:
            print(json.dumps({"job_id": job_id, "state": "submitted"}))
            return 0
        view = client.wait(job_id)
        out = dict(view)
        if view.get("state") == "done":
            results = client.results(job_id)
            out["results"] = len(results)
            if args.out:
                from fiber_tpu_torch import serialization

                with open(args.out, "wb") as fh:
                    fh.write(serialization.dumps(results))
                out["out"] = args.out
        print(json.dumps(out))
        return 0 if view.get("state") == "done" else 1
    except ServeError as err:
        raise SystemExit(f"error: {err}") from None
    finally:
        client.close()


def cmd_cancel(args) -> int:
    """Cancel a running serve-daemon job (parked resumable: its ledger
    survives, so resubmitting the same job_id resumes it)."""
    from fiber_tpu_torch.serve.client import ServeClient, ServeError

    client = ServeClient(_serve_address(args.serve))
    try:
        print(json.dumps(client.cancel(args.job_id)))
        return 0
    except ServeError as err:
        raise SystemExit(f"error: {err}") from None
    finally:
        client.close()


def cmd_slo(args) -> int:
    """Per-tenant SLO report from a serve daemon (docs/observability.md
    "SLOs and the archive"): SLI percentiles from the fixed-bucket
    histograms, error rates, and the fast/slow burn rates each armed
    objective is running at."""
    from fiber_tpu_torch.serve.client import ServeClient, ServeError

    client = ServeClient(_serve_address(args.serve))
    try:
        snap = client.slo(args.tenant or None)
    except (ServeError, OSError, EOFError) as err:
        raise SystemExit(f"error: {err}") from None
    finally:
        client.close()
    if args.json:
        print(json.dumps(snap, default=str))
        return 0
    t = snap.get("targets") or {}
    objectives = [f"{name}<={t[key]}s" for name, key in
                  (("latency", "latency_s"), ("queue", "queue_s"))
                  if t.get(key)]  # unset objective: no target, no column
    print(f"targets: {' '.join(objectives) or '(none)'} p={t.get('p')} "
          f"error_budget={t.get('error_pct', 0):.2%} "
          f"burn>={t.get('burn_threshold')}x "
          f"windows={t.get('fast_window_s'):.0f}s/"
          f"{t.get('window_s'):.0f}s")
    print(f"state: {'BURNING' if snap.get('breached') else 'ok'} "
          f"({snap.get('window_jobs', 0)} job(s) in window, "
          f"{snap.get('observations', 0)} observed)")
    tenants = snap.get("tenants") or {}
    if not tenants:
        print("no observations yet")
        return 0
    print(f"{'tenant':<16} {'jobs':>5} {'err%':>6} {'q_p95':>7} "
          f"{'lat_p50':>8} {'lat_p95':>8} {'tasks':>7}  burn")
    for name in sorted(tenants):
        ten = tenants[name]
        jobs_n = sum((ten.get("jobs") or {}).values())
        lat = ten.get("latency") or {}
        q = ten.get("queue_wait") or {}
        burns = []
        for obj, b in sorted((ten.get("burn") or {}).items()):
            bf = b.get("burn_fast")
            if bf is not None:
                burns.append(f"{obj}={bf:g}x")
        fmt = lambda v, suf="s": f"{v:g}{suf}" if v is not None else "-"
        print(f"{name:<16} {jobs_n:>5} "
              f"{ten.get('error_rate', 0.0):>6.1%} "
              f"{fmt(q.get('p95')):>7} {fmt(lat.get('p50')):>8} "
              f"{fmt(lat.get('p95')):>8} {ten.get('tasks', 0):>7}  "
              + (" ".join(burns) or "-"))
    return 1 if snap.get("breached") else 0


def cmd_history(args) -> int:
    """Query a serve daemon's persistent observability archive
    (docs/observability.md "SLOs and the archive"): time-range records
    of one metric — a sample field (``tasks_per_s``), or a record kind
    (``event`` / ``slo_obs`` / ``cost`` / ``sample``) — optionally
    label-filtered (``--label rule=slo_burn``)."""
    from fiber_tpu_torch.serve.client import ServeClient, ServeError

    labels = {}
    for item in args.label or []:
        if "=" not in item:
            raise SystemExit(
                f"error: --label wants key=value, got {item!r}")
        k, _, v = item.partition("=")
        labels[k] = v
    now = time.time()
    since = now - args.since if args.since else None
    until = now - args.until if args.until else None
    client = ServeClient(_serve_address(args.serve))
    try:
        records = client.query(args.metric, since=since, until=until,
                               labels=labels or None, limit=args.limit)
    except (ServeError, OSError, EOFError) as err:
        raise SystemExit(f"error: {err}") from None
    finally:
        client.close()
    if args.json:
        print(json.dumps(records, default=str))
        return 0
    for rec in records:
        stamp = time.strftime("%H:%M:%S",
                              time.localtime(float(rec.get("ts") or 0)))
        if set(rec) == {"ts", "value"}:
            print(f"[{stamp}] {rec['value']}")
            continue
        rest = " ".join(f"{k}={v}" for k, v in sorted(rec.items())
                        if k not in ("ts", "kind"))
        print(f"[{stamp}] {rec.get('kind')} {rest}")
    if not records:
        print(f"no {args.metric!r} records in range", file=sys.stderr)
    return 0


def cmd_logs(args) -> int:
    """Fetch a job's log tail by its jid (``host:port/jid`` — as printed
    by ``run --submit`` and carried by ``Process.job.jid``)."""
    from fiber_tpu_torch.backends.tpu import AgentClient

    if "/" not in args.jid:
        raise SystemExit("error: jid must look like host:port/jobid")
    addr, _, jid_s = args.jid.rpartition("/")
    host, _, port_s = addr.rpartition(":")
    if not host or not port_s.isdigit() or not jid_s.isdigit():
        raise SystemExit("error: jid must look like host:port/jobid")
    if args.bytes <= 0:
        raise SystemExit("error: --bytes must be positive")
    client = AgentClient(host, int(port_s))
    try:
        sys.stdout.write(client.call("logs", int(jid_s), args.bytes))
    except Exception as err:
        raise SystemExit(f"error: {err}") from None
    finally:
        client.close()
    return 0


def cmd_cp(args) -> int:
    """Stage files: local -> all hosts, or host:path -> local.

    Reference parity: fiber/cli.py:112-170 (``fiber cp`` via PVC pod).
    """
    from fiber_tpu_torch.backends.tpu import AgentClient

    hosts = _resolve_cli_hosts(args)
    if ":" in args.src and not os.path.exists(args.src):
        host_part, path = args.src.split(":", 1)
        matches = [h for h in hosts if h[0] == host_part]
        if not matches:
            raise SystemExit(f"error: host {host_part!r} not in --hosts")
        client = AgentClient(*matches[0])
        data = client.call("get_file", path)
        with open(args.dst, "wb") as fh:
            fh.write(data)
        print(f"fetched {len(data)} bytes from {args.src} -> {args.dst}")
        return 0
    with open(args.src, "rb") as fh:
        data = fh.read()
    mode = os.stat(args.src).st_mode & 0o777
    for host in hosts:
        AgentClient(*host).call("put_file", args.dst, data, mode)
        print(f"staged {args.src} -> {host[0]}:{args.dst} ({len(data)} bytes)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="fiber-tpu-torch",
        description="fiber_tpu_torch (PyTorch / CUDA port) CLI",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("run", help="run a program on the cluster")
    p.add_argument("--backend", default="")
    p.add_argument("--hosts", default="")
    p.add_argument("--submit", action="store_true",
                   help="launch the master itself as a cluster job "
                        "(submit-and-detach for long pod runs)")
    p.add_argument("--follow", action="store_true",
                   help="with --submit: attach and stream the job's log "
                        "tail until it exits")
    p.add_argument("--python", default=sys.executable,
                   help="remote interpreter for --submit")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sim", help="run against a simulated N-host cluster")
    p.add_argument("n", type=int)
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("agent", help="run the per-host agent daemon")
    p.add_argument("--port", type=int, default=7060)
    p.add_argument("--bind", default="127.0.0.1",
                   help="interface to bind; non-loopback requires "
                        "FIBER_CLUSTER_KEY")
    p.add_argument("--announce", action="store_true")
    p.add_argument("--unrestricted-files", action="store_true",
                   help="allow put_file/get_file anywhere on disk")
    p.set_defaults(fn=cmd_agent)

    p = sub.add_parser(
        "up", help="start agents on every pod-slice host and wait for "
                   "them (--dry-run prints the commands instead)")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="", help="TPU name (gcloud ssh path)")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--python", default="python3")
    p.add_argument("--dry-run", action="store_true",
                   help="print the bring-up commands without running")
    p.add_argument("--wait", type=float, default=60.0,
                   help="seconds to wait for agents to answer (with "
                        "--tpu and no --hosts, 0 skips verification "
                        "explicitly; with --hosts, 0 = one immediate "
                        "probe pass)")
    # compat: execution is the default now
    p.add_argument("--execute", action="store_true",
                   help=argparse.SUPPRESS)
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser("down", help="stop agents via their shutdown RPC")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe (same derivation as `up --tpu`)")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0)
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("status", help="ping every host agent")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.add_argument("--json", action="store_true",
                   help="print the per-host rows as a JSON list")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("metrics",
                       help="fetch and render every host agent's "
                            "telemetry snapshot")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.add_argument("--prom", action="store_true",
                   help="render as Prometheus v0.0.4 text exposition "
                        "(host-labeled)")
    p.add_argument("--json", action="store_true",
                   help="print the raw per-host snapshots as JSON")
    p.add_argument("--watch", type=float, default=0.0,
                   help="poll every N seconds and print deltas/rates "
                        "between consecutive snapshots instead of raw "
                        "counters")
    p.add_argument("--count", type=int, default=0,
                   help="with --watch: delta rounds to print before "
                        "exiting (0 = until Ctrl-C)")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "top", help="live per-host table: evals/s, inflight, queue, "
                    "bytes/s, heartbeat age, anomaly flags")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.add_argument("--interval", type=float, default=2.0,
                   help="seconds between refreshes")
    p.add_argument("--iterations", type=int, default=0,
                   help="frames to render before exiting "
                        "(0 = until Ctrl-C)")
    p.add_argument("--history", type=int, default=120,
                   help="time-series points pulled per host")
    p.add_argument("--last", type=int, default=8,
                   help="recent anomalies shown under the table")
    p.add_argument("--no-clear", action="store_true",
                   help="append frames instead of clearing the screen")
    p.add_argument("--costs", action="store_true",
                   help="also pull each host's accounting snapshot and "
                        "show the top billing keys (tasks, cpu, wire, "
                        "device seconds)")
    p.add_argument("--json", action="store_true",
                   help="print raw per-host monitor snapshots as JSON")
    p.add_argument("--serve", default="",
                   help="also show a serve daemon's state (jobs by "
                        "state, warm pool, admission); host:port, "
                        "default port from serve_port config")
    p.set_defaults(fn=cmd_top)

    p = sub.add_parser(
        "devices", help="per-host device telemetry: transfer "
                        "bytes/seconds, compiles, HBM, live arrays, "
                        "recompile state, live MFU")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.add_argument("--sites", action="store_true",
                   help="also print per-site transfer accounting "
                        "(store_resolve / deserialize / dmap / "
                        "checkpoint)")
    p.add_argument("--json", action="store_true",
                   help="print the raw per-host snapshots as JSON")
    p.set_defaults(fn=cmd_devices)

    p = sub.add_parser(
        "profile", help="sampling profiler: run a script under it, or "
                        "pull on-demand agent profiles (--hosts)")
    p.add_argument("script", nargs="?", default="",
                   help="script to run under the profiler (omit with "
                        "--hosts to pull agent profiles instead)")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    p.add_argument("--out", default="prof.folded",
                   help="flamegraph folded output path")
    p.add_argument("--chrome", default="",
                   help="also write a Chrome-trace flame view here")
    p.add_argument("--hz", type=float, default=97.0,
                   help="stack samples per second")
    p.add_argument("--seconds", type=float, default=1.0,
                   help="with --hosts: burst duration per agent")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.set_defaults(fn=cmd_profile)

    p = sub.add_parser("explain",
                       help="classify where a traced map's time went "
                            "(straggler / locality-miss / backpressure "
                            "/ transport-stall / store-fetch)")
    p.add_argument("trace",
                   help="trace artifact: Pool.trace_dump Chrome JSON "
                        "or a raw span-list JSON")
    p.add_argument("--flight", default="",
                   help="flight-event artifact (Pool.flight_dump JSON) "
                        "to join with the spans")
    p.add_argument("--trace-id", default="",
                   help="trace to explain (default: the one with the "
                        "most spans in the artifact)")
    p.add_argument("--quantile", type=float, default=2.0,
                   help="straggler threshold: chunks slower than this "
                        "multiple of the map median are blamed")
    p.add_argument("--profile", default="",
                   help="folded sampling profile (Pool.profile_dump / "
                        "fiber-tpu profile output): a compute verdict "
                        "then names the top frames")
    p.add_argument("--json", action="store_true",
                   help="print the raw verdict as JSON")
    p.set_defaults(fn=cmd_explain)

    p = sub.add_parser(
        "policies", help="autonomous operations: the policy table, "
                         "recent remediations and their verified "
                         "outcomes")
    p.add_argument("--hosts", default="",
                   help="pull each agent's recent policy actions "
                        "instead of the local engine")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.add_argument("--flight", default="",
                   help="narrate the anomaly -> action -> outcome "
                        "chains of a flight artifact instead")
    p.add_argument("--last", type=int, default=12,
                   help="recent actions shown")
    p.add_argument("--json", action="store_true",
                   help="print the raw snapshot / chains as JSON")
    p.set_defaults(fn=cmd_policies)

    p = sub.add_parser("postmortem",
                       help="list/print black-box bundles (dead-worker "
                            "flight events + stack dumps)")
    p.add_argument("--hosts", default="",
                   help="pull each agent's postmortem op instead of "
                        "reading the local staging root")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.add_argument("--dir", default="",
                   help="local bundle directory (default: "
                        "<staging root>/postmortem)")
    p.add_argument("--last", type=int, default=8,
                   help="newest bundles to show per source")
    p.add_argument("--json", action="store_true",
                   help="print full bundles as JSON")
    p.set_defaults(fn=cmd_postmortem)

    p = sub.add_parser("doctor",
                       help="diagnose the environment and cluster")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.add_argument("--timeout", type=float, default=20.0,
                   help="seconds to wait for the CUDA device probe")
    p.set_defaults(fn=cmd_doctor)

    p = sub.add_parser(
        "resume", help="resume a crashed durable map from its "
                       "write-ahead ledger (Pool.map job_id=)")
    p.add_argument("job_id", help="the job_id passed to Pool.map")
    p.add_argument("--ledger-dir", default="",
                   help="ledger directory (default: config ledger_dir "
                        "or <staging root>/ledger)")
    p.add_argument("--processes", type=int, default=0,
                   help="pool size for the resumed run (default: "
                        "backend default)")
    p.add_argument("--out", default="",
                   help="write the full result list (pickled) here")
    p.set_defaults(fn=cmd_resume)

    p = sub.add_parser(
        "cost", help="render one job's CostReport (per-map resource "
                     "accounting: tasks, cpu, wire, store, device)")
    p.add_argument("job_id", help="the job_id passed to Pool.map")
    p.add_argument("--dir", default="",
                   help="cost-record directory (default: config "
                        "cost_dir or <staging root>/costs)")
    p.add_argument("--hosts", default="",
                   help="pull live per-host cost ledgers instead of "
                        "the persisted record")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.add_argument("--json", action="store_true",
                   help="print the raw record/snapshots as JSON")
    p.set_defaults(fn=cmd_cost)

    p = sub.add_parser("jobs",
                       help="list durable-map ledgers and their state")
    p.add_argument("--ledger-dir", default="")
    p.add_argument("--tenant", default="",
                   help="only jobs billed to this tenant (from the "
                        "persisted per-job cost records)")
    p.add_argument("--json", action="store_true",
                   help="print the job rows as a JSON list")
    p.set_defaults(fn=cmd_jobs)

    p = sub.add_parser(
        "serve", help="run the long-lived multi-tenant serving daemon "
                      "(submit/poll/cancel over the authenticated "
                      "cluster channel)")
    p.add_argument("--backend", default="", choices=("", "local", "tpu"))
    p.add_argument("--port", type=int, default=0,
                   help="RPC port (default: serve_port config)")
    p.add_argument("--bind", default="127.0.0.1",
                   help="interface to bind; non-loopback requires "
                        "FIBER_CLUSTER_KEY")
    p.add_argument("--processes", type=int, default=0,
                   help="worker-slot ceiling for the shared pool")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser(
        "submit", help="submit one job to a running serve daemon")
    p.add_argument("func", help="module:function (importable on the "
                                "daemon's PYTHONPATH)")
    p.add_argument("--items", required=True,
                   help="JSON list of task items")
    p.add_argument("--tenant", default="default")
    p.add_argument("--job-id", default="",
                   help="durable job id (generated when omitted); "
                        "resubmitting an id resumes its ledger")
    p.add_argument("--star", action="store_true",
                   help="starmap: each item is an argument tuple")
    p.add_argument("--chunksize", type=int, default=0)
    p.add_argument("--budget", default="",
                   help='JSON CostBudget fields, e.g. '
                        '\'{"tasks": 100, "cpu_s": 5}\'')
    p.add_argument("--serve", default="",
                   help="daemon address host:port (default "
                        "127.0.0.1:<serve_port>)")
    p.add_argument("--wait", action="store_true",
                   help="poll until the job finishes and print the "
                        "final state")
    p.add_argument("--out", default="",
                   help="with --wait: write the result list (pickled) "
                        "here")
    p.set_defaults(fn=cmd_submit)

    p = sub.add_parser(
        "cancel", help="cancel a serve-daemon job (parked resumable)")
    p.add_argument("job_id")
    p.add_argument("--serve", default="",
                   help="daemon address host:port (default "
                        "127.0.0.1:<serve_port>)")
    p.set_defaults(fn=cmd_cancel)

    p = sub.add_parser(
        "slo", help="per-tenant SLO report from a serve daemon "
                    "(exit 1 while an objective is burning)")
    p.add_argument("--tenant", default="",
                   help="report just this tenant")
    p.add_argument("--serve", default="",
                   help="daemon address host:port (default "
                        "127.0.0.1:<serve_port>)")
    p.add_argument("--json", action="store_true",
                   help="print the raw snapshot as JSON")
    p.set_defaults(fn=cmd_slo)

    p = sub.add_parser(
        "history", help="query the serve daemon's observability "
                        "archive for one metric's time range")
    p.add_argument("metric",
                   help="sample field (tasks_per_s) or record kind "
                        "(event / slo_obs / cost / sample)")
    p.add_argument("--since", type=float, default=0.0,
                   help="seconds ago to start the range (0 = all "
                        "retained history)")
    p.add_argument("--until", type=float, default=0.0,
                   help="seconds ago to end the range (0 = now)")
    p.add_argument("--label", action="append", default=[],
                   help="key=value record filter, repeatable "
                        "(e.g. --label rule=slo_burn)")
    p.add_argument("--limit", type=int, default=1000)
    p.add_argument("--serve", default="",
                   help="daemon address host:port (default "
                        "127.0.0.1:<serve_port>)")
    p.add_argument("--json", action="store_true",
                   help="print the records as JSON")
    p.set_defaults(fn=cmd_history)

    p = sub.add_parser("logs", help="fetch a job's log tail by jid")
    p.add_argument("jid", help="host:port/jobid (as printed by --submit)")
    p.add_argument("--bytes", type=int, default=65536)
    p.set_defaults(fn=cmd_logs)

    p = sub.add_parser("cp", help="stage files to/from hosts")
    p.add_argument("src")
    p.add_argument("dst")
    p.add_argument("--hosts", default="")
    p.add_argument("--tpu", default="",
                   help="TPU name: derive worker addresses via gcloud "
                        "describe when --hosts is absent")
    p.add_argument("--zone", default="")
    p.add_argument("--port", type=int, default=0,
                   help="port for portless --hosts entries / derived "
                        "addresses")
    p.set_defaults(fn=cmd_cp)

    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
