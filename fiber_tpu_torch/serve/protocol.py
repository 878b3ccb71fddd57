"""Serve-tier wire protocol: verbs, job states, payload validation
(docs/serving.md "Protocol").

Every request on the authenticated channel is one picklable tuple
``(op, payload)`` — ``op`` a verb string, ``payload`` a dict — and
every reply rides :func:`fiber_tpu_torch.utils.serve.serve_request_reply`'s
``(True, result)`` / ``(False, repr(exc))`` convention, so the client
is :class:`fiber_tpu_torch.backends.tpu.AgentClient`-shaped and any agent-
plane tooling can speak to the daemon.

The module is deliberately dependency-light (no pool/daemon imports):
it is the one file both sides share.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Tuple

#: Bumped on any incompatible verb/payload change; the daemon refuses
#: requests from a different major version (status carries it so a
#: client can print a useful mismatch error).
PROTOCOL_VERSION = 1

# -- verbs -------------------------------------------------------------
#: Client-callable ops (daemon's _op_<name> methods).
VERBS = (
    "ping",       # liveness: -> "pong"
    "status",     # daemon state snapshot (fiber-tpu top)
    "submit",     # new job -> {"job_id", "state"}
    "poll",       # job state -> job dict
    "results",    # completed job's results -> serialized list
    "cancel",     # stop a running job (parked resumable)
    "jobs",       # list jobs, optional tenant filter
    "query",      # archive time-range query (fiber-tpu history)
    "slo",        # per-tenant SLI/SLO snapshot (fiber-tpu slo)
    "shutdown",   # stop serving (admin)
)

# -- job states --------------------------------------------------------
QUEUED = "queued"          # admitted, not yet dispatched
RUNNING = "running"        # chunks in flight on the shared pool
DONE = "done"              # all results in; `results` verb will serve
FAILED = "failed"          # task/user error; error field carries repr
CANCELLED = "cancelled"    # client cancel; ledger kept, resumable
PREEMPTED = "preempted"    # budget enforcement; ledger kept, resumable
REJECTED = "rejected"      # admission refused it (never dispatched)

JOB_STATES = (QUEUED, RUNNING, DONE, FAILED, CANCELLED, PREEMPTED,
              REJECTED)

#: States a daemon restart must pick back up from the ledger.
REPLAYABLE_STATES = (QUEUED, RUNNING)

#: States whose results/verdict are final.
TERMINAL_STATES = (DONE, FAILED, CANCELLED, PREEMPTED, REJECTED)

_TENANT_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")


def check_tenant(name: str) -> str:
    """Validate a tenant label (it becomes a billing-key component, a
    metric label and part of on-disk record paths — same alphabet as
    ledger job ids)."""
    if not isinstance(name, str) or not _TENANT_RE.match(name):
        raise ValueError(
            f"invalid tenant {name!r}: want 1-64 chars of [A-Za-z0-9._-]")
    return name


def request(op: str, **payload: Any) -> Tuple[str, Dict[str, Any]]:
    """Build one wire request (client side)."""
    if op not in VERBS:
        raise ValueError(f"unknown serve op {op!r}")
    return op, payload


def parse_request(req: Any) -> Tuple[str, Dict[str, Any]]:
    """Validate one wire request (daemon side). Raises ValueError on
    anything malformed — serve_request_reply turns that into the
    ``(False, repr)`` reply instead of killing the connection."""
    if (not isinstance(req, tuple) or len(req) != 2
            or not isinstance(req[0], str)
            or not isinstance(req[1], dict)):
        raise ValueError(f"malformed serve request: {type(req).__name__}")
    op, payload = req
    if op not in VERBS:
        raise ValueError(f"unknown serve op {op!r}")
    return op, payload
