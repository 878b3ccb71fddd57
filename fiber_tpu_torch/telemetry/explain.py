"""``fiber-tpu explain``: join spans + flight events and classify where
a map's time went (docs/observability.md).

Tracing answers *what happened*: the spans of one trace id show
serialize → dispatch → resolve-refs → execute → result across the
cluster. This module answers *why was it slow*, by joining those spans
with the flight recorder's decision/anomaly events and attributing
seconds to the five blame categories the training/inference stacks
debug daily:

==================  =====================================================
straggler           excess service time of outlier chunks — per-chunk
                    handout→result durations (``sched``/``chunk_done``
                    events, falling back to execute-span durations) above
                    ``quantile`` x the map's median; ``speculate`` events
                    are corroborating evidence
store_fetch         worker-side ref resolution (``worker.resolve_refs``
                    span durations)
locality_miss       the subset of store traffic that crossed the wire
                    (``store``/``fetch`` events with ``wire=True``) —
                    payload fetched where it did NOT already live
backpressure        submit-side waits on the in-flight cap
                    (``pool``/``backpressure`` events, ``wait_s``)
transport_stall     ingress stalls/parks observed by either I/O engine
                    (``transport``/``stall`` + ``park`` events)
==================  =====================================================

The verdict is a **ranked budget**: seconds attributed per category,
plus ``primary`` — the top category with nonzero blame (or
``"compute"`` when nothing above explains the wall clock, i.e. the map
was simply busy). All inputs are artifacts (the Chrome trace written by
``Pool.trace_dump`` / ``bench.py --cluster`` and the flight-event JSON
from ``Pool.flight_dump``), so the CLI runs offline against any
recorded run.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: Blame categories, ranked in the verdict (compute is context, not
#: blame — it appears in the budget but never as primary unless nothing
#: else has weight).
CATEGORIES = ("straggler", "transfer", "store_fetch", "locality_miss",
              "backpressure", "transport_stall", "fanout")


def spans_from_chrome(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Invert export.chrome_trace: complete (``ph == "X"``) events back
    into span dicts (ts/dur in seconds, args flattened)."""
    pid_to_host = {
        e.get("pid"): e.get("args", {}).get("name")
        for e in doc.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    spans = []
    for e in doc.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        sp = dict(e.get("args") or {})
        sp["name"] = e.get("name", "span")
        sp["ts"] = float(e.get("ts", 0.0)) / 1e6
        sp["dur"] = float(e.get("dur", 0.0)) / 1e6
        sp.setdefault("host", pid_to_host.get(e.get("pid"), "host"))
        sp.setdefault("pid", e.get("tid", 0))
        spans.append(sp)
    return spans


def load_spans(path: str) -> List[Dict[str, Any]]:
    """Spans from a file: a Chrome trace-event JSON object (trace_dump
    output) or a plain JSON list of span dicts."""
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict) and "traceEvents" in doc:
        return spans_from_chrome(doc)
    if isinstance(doc, list):
        return doc
    raise ValueError(f"{path!r} holds neither a Chrome trace nor a "
                     "span list")


def load_events(path: str) -> List[Dict[str, Any]]:
    """Flight events from a file: a JSON list, or the ``Pool.flight_dump``
    envelope ``{"events": [...]}``. Events are merge-ordered on
    ``(wall, monotonic)`` — artifacts concatenated from several
    processes interleave correctly (flightrec.order_events)."""
    from fiber_tpu_torch.telemetry.flightrec import order_events

    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict):
        doc = doc.get("events", [])
    if not isinstance(doc, list):
        raise ValueError(f"{path!r} holds no flight-event list")
    return order_events(doc)


def load_logs(path: str, last: int = 12) -> List[str]:
    """The log-ring tail a ``Pool.flight_dump`` artifact carries (the
    logs pillar beside the flight events): the last ``last`` lines, or
    ``[]`` for artifacts written before the ring existed / raw event
    lists."""
    try:
        with open(path) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return []
    if not isinstance(doc, dict):
        return []
    logs = doc.get("logs")
    if not isinstance(logs, list):
        return []
    return [str(line) for line in logs[-max(0, int(last)):]]


def _dominant_trace(spans: Sequence[Dict[str, Any]]) -> Optional[str]:
    counts: Dict[str, int] = {}
    for sp in spans:
        tid = sp.get("trace")
        if tid:
            counts[tid] = counts.get(tid, 0) + 1
    return max(counts, key=counts.get) if counts else None


def _median(values: Sequence[float]) -> float:
    ordered = sorted(values)
    return ordered[len(ordered) // 2] if ordered else 0.0


def explain_trace(spans: Sequence[Dict[str, Any]],
                  events: Iterable[Dict[str, Any]] = (),
                  trace_id: Optional[str] = None,
                  quantile: float = 2.0,
                  profile: Optional[Dict[str, int]] = None
                  ) -> Dict[str, Any]:
    """Classify one trace's time. ``trace_id`` defaults to the trace
    with the most spans (the artifact usually holds exactly the traced
    map plus stragglers of earlier ones)."""
    trace_id = trace_id or _dominant_trace(spans)
    mine = [sp for sp in spans if sp.get("trace") == trace_id]
    if not mine:
        raise ValueError(f"no spans for trace {trace_id!r}")
    t0 = min(float(sp.get("ts", 0.0)) for sp in mine)
    t1 = max(float(sp.get("ts", 0.0)) + float(sp.get("dur", 0.0))
             for sp in mine)
    seqs = {sp["seq"] for sp in mine if sp.get("seq") is not None}

    def in_scope(ev: Dict[str, Any]) -> bool:
        seq = ev.get("seq")
        if seq is not None and seqs:
            return seq in seqs
        # seq-less events (transport, store wire traffic) join by time:
        # the trace window plus a little slack for clock skew.
        return t0 - 0.5 <= float(ev.get("ts", 0.0)) <= t1 + 0.5

    scoped = [ev for ev in events if in_scope(ev)]

    budget: Dict[str, float] = {c: 0.0 for c in CATEGORIES}
    evidence: Dict[str, Any] = {"trace": trace_id,
                                "seqs": sorted(seqs),
                                "events_considered": len(scoped)}

    execute = [sp for sp in mine if sp.get("name") == "worker.execute"]
    budget["compute"] = sum(float(sp.get("dur", 0.0)) for sp in execute)
    budget["store_fetch"] = sum(
        float(sp.get("dur", 0.0)) for sp in mine
        if sp.get("name") == "worker.resolve_refs")
    budget["serialize"] = sum(
        float(sp.get("dur", 0.0)) for sp in mine
        if sp.get("name") == "pool.serialize")

    # Straggler: per-chunk service times (handout -> result) from the
    # scheduler's chunk_done events; execute spans are the fallback for
    # artifacts recorded without the flight recorder. Blame is the
    # EXCESS above quantile x median — a uniformly slow map is compute,
    # not a straggler.
    durs = [float(ev.get("dur", 0.0)) for ev in scoped
            if ev.get("plane") == "sched" and ev.get("kind") == "chunk_done"]
    dur_source = "sched.chunk_done"
    if not durs:
        durs = [float(sp.get("dur", 0.0)) for sp in execute]
        dur_source = "worker.execute"
    median = _median(durs)
    threshold = max(quantile, 1.0) * median
    excess = [d - threshold for d in durs if d > threshold]
    budget["straggler"] = sum(excess)
    speculated = sum(1 for ev in scoped
                     if ev.get("plane") == "sched"
                     and ev.get("kind") == "speculate")
    evidence["straggler"] = {
        "chunks": len(durs), "median_s": round(median, 6),
        "outliers": len(excess), "speculations": speculated,
        "source": dur_source,
    }

    # Transfer: seconds spent crossing the host->device boundary
    # (device telemetry plane — ``device``/``transfer`` flight events;
    # ``device.transfer`` spans are the fallback for artifacts recorded
    # without the flight recorder). The transferred bytes are the
    # evidence: a verdict naming transfer should say HOW MUCH crossed.
    xfer_events = [ev for ev in scoped
                   if ev.get("plane") == "device"
                   and ev.get("kind") == "transfer"]
    xfer_source = "device.transfer events"
    by_site: Dict[str, Dict[str, float]] = {}

    def _site_add(site: str, secs: float, nbytes: int) -> None:
        slot = by_site.setdefault(site, {"transfers": 0, "bytes": 0,
                                         "s": 0.0})
        slot["transfers"] += 1
        slot["bytes"] += nbytes
        slot["s"] += secs

    if xfer_events:
        budget["transfer"] = sum(float(ev.get("s", 0.0))
                                 for ev in xfer_events)
        xfer_bytes = sum(int(ev.get("bytes", 0)) for ev in xfer_events)
        xfer_count = len(xfer_events)
        for ev in xfer_events:
            _site_add(str(ev.get("site", "?")), float(ev.get("s", 0.0)),
                      int(ev.get("bytes", 0)))
    else:
        xfer_spans = [sp for sp in mine
                      if sp.get("name") == "device.transfer"]
        budget["transfer"] = sum(float(sp.get("dur", 0.0))
                                 for sp in xfer_spans)
        xfer_bytes = sum(int(sp.get("bytes", 0)) for sp in xfer_spans)
        xfer_count = len(xfer_spans)
        xfer_source = "device.transfer spans"
        for sp in xfer_spans:
            _site_add(str(sp.get("site", "?")),
                      float(sp.get("dur", 0.0)), int(sp.get("bytes", 0)))
    # The ICI-vs-wire blame split (docs/objectstore.md "Device tier"):
    # `ici` transfers are mesh fan-out (device-tier placement) — bytes
    # that did NOT cross sockets; wire bytes come from the store's
    # wire-fetch events below. A verdict can now say "this map moved
    # 64MB, 60MB of it over ICI".
    evidence["transfer"] = {
        "transfers": xfer_count, "bytes": xfer_bytes,
        "source": xfer_source,
        "by_site": {site: {"transfers": int(v["transfers"]),
                           "bytes": int(v["bytes"]),
                           "s": round(v["s"], 6)}
                    for site, v in sorted(by_site.items())},
        "ici_bytes": int(by_site.get("ici", {}).get("bytes", 0)),
    }

    wire_fetches = [ev for ev in scoped
                    if ev.get("plane") == "store"
                    and ev.get("kind") == "fetch" and ev.get("wire")]
    wire_bytes = sum(int(ev.get("bytes", 0)) for ev in wire_fetches)
    budget["locality_miss"] = sum(float(ev.get("s", 0.0))
                                  for ev in wire_fetches)
    evidence["locality_miss"] = {
        "wire_fetches": len(wire_fetches),
        "bytes": wire_bytes,
    }
    evidence["transfer"]["wire_bytes"] = wire_bytes

    budget["backpressure"] = sum(
        float(ev.get("wait_s", 0.0)) for ev in scoped
        if ev.get("plane") == "pool" and ev.get("kind") == "backpressure")
    budget["transport_stall"] = sum(
        float(ev.get("stall_s", 0.0)) for ev in scoped
        if ev.get("plane") == "transport"
        and ev.get("kind") in ("stall", "park"))
    # Hierarchical dispatch: seconds a per-host sub-master spent
    # blocked feeding its local sub-workers (sched/hier.py records a
    # fanout_stall per blocked feed) — the range handout outran the
    # host's compute, so the fan-out itself is the bottleneck.
    fanout_stalls = [ev for ev in scoped
                     if ev.get("plane") == "hier"
                     and ev.get("kind") == "fanout_stall"]
    budget["fanout"] = sum(float(ev.get("wait_s", 0.0))
                           for ev in fanout_stalls)
    evidence["fanout"] = {"stalls": len(fanout_stalls)}

    ranked = sorted(((c, budget[c]) for c in CATEGORIES),
                    key=lambda kv: kv[1], reverse=True)
    primary = ranked[0][0] if ranked[0][1] > 0.0 else "compute"
    if profile:
        # A sampling profile (folded stacks — telemetry/profiler.py)
        # makes a compute verdict actionable: the evidence names WHICH
        # Python frames burned the samples instead of stopping at
        # "compute".
        from fiber_tpu_torch.telemetry.profiler import top_frames

        evidence["compute_frames"] = [
            {"frame": frame, "samples": count}
            for frame, count in top_frames(profile, 5)
        ]
    return {
        "trace": trace_id,
        "wall_s": round(t1 - t0, 6),
        "spans": len(mine),
        "budget": {k: round(v, 6) for k, v in budget.items()},
        "ranked": [(c, round(s, 6)) for c, s in ranked],
        "primary": primary,
        "evidence": evidence,
    }


def policy_chains(events: Iterable[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Join anomaly -> action -> outcome by event id (docs/
    observability.md "Autonomous operations"): every ``monitor``-plane
    anomaly event is a potential cause; ``policy``-plane events carry
    ``cause_id`` pointing back at it. Returns one chain per anomaly
    that drew ANY policy activity (actions, suppressions, reverts,
    outcomes), in event order."""
    events = list(events)
    anomalies: Dict[str, Dict[str, Any]] = {
        e["id"]: e for e in events
        if e.get("plane") == "monitor" and e.get("kind") != "clear"
        and e.get("id")}
    chains: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for e in events:
        if e.get("plane") != "policy":
            continue
        cid = e.get("cause_id")
        if not cid:
            continue
        chain = chains.get(cid)
        if chain is None:
            chain = chains[cid] = {
                "cause_id": cid,
                "anomaly": anomalies.get(cid),
                "actions": [], "outcomes": [], "notes": [],
            }
            order.append(cid)
        kind = e.get("kind")
        if kind == "outcome":
            chain["outcomes"].append(e)
        elif kind in ("suppressed", "revert"):
            chain["notes"].append(e)
        else:
            chain["actions"].append(e)
    return [chains[cid] for cid in order]


def render_chains(chains: Sequence[Dict[str, Any]]) -> str:
    """Narrate the anomaly -> action -> outcome chains (the CLI's
    ``explain --flight`` tail and ``fiber-tpu policies --events``)."""
    if not chains:
        return "autonomous operations: no policy activity recorded"
    lines = [f"autonomous operations: {len(chains)} anomaly chain(s)"]
    for chain in chains:
        anom = chain.get("anomaly")
        if anom is not None:
            rule = anom.get("kind", "?")
            detail = anom.get("detail", "")
            lines.append(f"anomaly {rule} [{chain['cause_id']}]: {detail}")
        else:
            lines.append(f"anomaly [{chain['cause_id']}] "
                         "(event outside this artifact)")
        for act in chain["actions"]:
            mode = ("dry-run" if act.get("dry_run")
                    else ("applied" if act.get("applied") else "no-op"))
            lines.append(f"  -> action {act.get('kind')} ({mode}): "
                         f"{act.get('detail', '')}")
        for note in chain["notes"]:
            lines.append(f"  .. {note.get('kind')}: "
                         f"{note.get('reason') or note.get('detail', '')}")
        for out in chain["outcomes"]:
            lines.append(f"  => outcome {out.get('outcome')}: "
                         f"{out.get('detail', '')}")
        if chain["actions"] and not chain["outcomes"]:
            lines.append("  => outcome pending (verification had not "
                         "run when the artifact was written)")
    return "\n".join(lines)


def render(verdict: Dict[str, Any]) -> str:
    """Human-readable ranked budget (the CLI's output)."""
    lines = [
        f"trace {verdict['trace']}  wall {verdict['wall_s']:.3f}s  "
        f"spans {verdict['spans']}",
        f"primary: {verdict['primary']}",
        "ranked budget (blame seconds):",
    ]
    for cat, secs in verdict["ranked"]:
        lines.append(f"  {cat:<16} {secs:.4f}")
    budget = verdict["budget"]
    lines.append(f"  {'compute':<16} {budget.get('compute', 0.0):.4f}"
                 "  (context, not blame)")
    if "serialize" in budget:
        lines.append(f"  {'serialize':<16} "
                     f"{budget['serialize']:.4f}  (context)")
    ev = verdict.get("evidence", {}).get("straggler")
    if ev:
        lines.append(
            f"straggler evidence: {ev['outliers']}/{ev['chunks']} outlier "
            f"chunk(s) vs median {ev['median_s']:.4f}s, "
            f"{ev['speculations']} speculation(s) [{ev['source']}]")
    ev = verdict.get("evidence", {}).get("transfer")
    if ev and verdict.get("primary") == "transfer":
        lines.append(
            f"transfer evidence: {ev['transfers']} host->device "
            f"transfer(s), {ev['bytes']} bytes [{ev['source']}]")
    if ev and (ev.get("ici_bytes") or ev.get("wire_bytes")):
        # The data-plane split: bytes that rode the mesh vs bytes that
        # crossed sockets (docs/objectstore.md "Device tier").
        lines.append(
            f"transfer split: ici {ev.get('ici_bytes', 0)}B over the "
            f"mesh, wire {ev.get('wire_bytes', 0)}B over sockets")
    frames = verdict.get("evidence", {}).get("compute_frames")
    if frames and verdict.get("primary") == "compute":
        lines.append("compute is the verdict — top sampled frames:")
        for entry in frames:
            lines.append(
                f"  {entry['samples']:>6}  {entry['frame']}")
    return "\n".join(lines)
