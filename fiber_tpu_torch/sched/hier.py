"""Hierarchical dispatch: the per-host sub-master (docs/architecture.md).

With ``dispatch_mode="hier"`` a packing parent (one job, ``cpu_per_job``
sub-worker slots) stops being a passive babysitter and becomes this
host's **sub-master**: it fetches whole chunk *ranges* from the master
(one REQ/REP frame per range instead of one per chunk), fans the chunks
to its local sub-workers over same-host transport (shm rings when the
engine is on), and streams results back upstream aggregated into
``("rbatch", ...)`` frames. Master frame count and encode CPU therefore
scale with *hosts*, not workers — the scale-out lever toward
million-task maps.

Semantics preserved relative to direct dispatch:

* the master's pending table holds every chunk of a handed-out range
  under the sub-master's ident — ``kill -9`` of the sub-master reclaims
  and resubmits all of them through the existing death path, and the
  pool degrades the host to direct per-worker dispatch on respawn;
* chunk payloads are encoded once by the master and never decoded here
  (ranges carry the raw payload bytes), so trace context and billing
  keys ride exactly as in direct mode;
* a crashed local sub-worker is respawned in place and every locally
  outstanding chunk is re-fed (duplicates are deduped by the master's
  ResultStore.fill — the same idempotence contract resilient pools
  already demand);
* ``storemiss`` reports are rewritten to the sub-master's ident before
  forwarding, so the master's pending/scheduler bookkeeping (which knows
  only this ident) stays exact;
* worker telemetry (``spans``/``prof``/``dev``/``cost`` frames) is
  batched into ``("fbatch", [raw, ...], ident)`` frames upstream — at
  one spans + one cost frame per chunk it would otherwise dominate
  master ingress; the master unpacks and dispatches each inner message
  through its normal handlers. Heartbeats are emitted by the
  sub-master itself;
* STREAMING maps (docs/streaming.md) ride unchanged: a range's chunk
  payload bytes are the only copy of its items (the master's producer
  iterator has moved on — the envelope-reuse rule), so the
  resubmission sources here (``_outstanding``) and at the master
  (pending table / scheduler payloads) work identically for streamed
  chunks. The scheduler additionally caps range size for streams
  (``Scheduler.range_cap``) so one host's range cannot swallow a whole
  admission window, and result batches flush immediately when nothing
  is locally outstanding — a held rbatch is held backpressure.

Local fan-out rides the idle C++ epoll pump (``libfiberpump.so``) when
it is available and the engine is TCP — under ``transport_io="shm"``
the Python endpoints ARE the fast path (per-channel rings), so the
sub-master binds them directly.
"""

from __future__ import annotations

import os
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

from fiber_tpu_torch import serialization
from fiber_tpu_torch.sched.core import local_host_key
from fiber_tpu_torch.telemetry.flightrec import FLIGHT
from fiber_tpu_torch.utils.logging import get_logger

logger = get_logger()

#: Result aggregation thresholds: a batch flushes upstream at this many
#: chunks, this many payload bytes, or this much staleness — whichever
#: first. The age bound alone caps result latency, so the chunk count
#: can sit high: it only engages when results arrive faster than
#: ``_BATCH_CHUNKS / _BATCH_AGE_S`` per second — exactly the
#: million-tiny-task regime whose upstream frame count must collapse.
_BATCH_CHUNKS = 64
_BATCH_BYTES = 512 * 1024
_BATCH_AGE_S = 0.02

#: Children's per-chunk telemetry frames ("spans"/"prof"/"dev"/"cost")
#: are batched upstream too — into ("fbatch", [raw, ...], ident) — with
#: lazier thresholds: telemetry tolerates seconds of staleness, and at
#: one spans + one cost frame per chunk these otherwise dominate master
#: ingress (2 frames/chunk vs 1/_BATCH_CHUNKS for results).
_FWD_KINDS = frozenset(("spans", "prof", "dev", "cost"))
_FWD_FRAMES = 128
_FWD_BYTES = 256 * 1024
_FWD_AGE_S = 0.25

#: A feed send blocked longer than this is recorded as a fanout stall —
#: the flight evidence `fiber-tpu explain` turns into a ``fanout`` blame
#: entry when the sub-master's local fan-out is the bottleneck.
_STALL_RECORD_S = 0.05


class HostDispatcher:
    """One per-host sub-master, run by ``pool_worker`` in place of the
    classic packing-parent monitor when hierarchical dispatch is on."""

    def __init__(
        self,
        task_addr: str,
        result_addr: str,
        n_local: int,
        initializer,
        initargs: Tuple,
        maxtasksperchild: Optional[int],
        store_addr: Optional[str],
    ) -> None:
        self._task_addr = task_addr
        self._result_addr = result_addr
        self._n_local = max(1, int(n_local))
        self._initializer = initializer
        self._initargs = initargs
        self._maxtasksperchild = maxtasksperchild
        self._store_addr = store_addr
        self.ident = uuid.uuid4().bytes
        #: (seq, base) -> payload for every chunk fed locally and not
        #: yet answered — the resubmission source on sub-worker death.
        self._outstanding: Dict[Tuple[int, int], bytes] = {}
        self._lock = threading.Lock()
        self._draining = threading.Event()  # master said exit
        self._failed = threading.Event()    # upstream connection died
        self._stop = threading.Event()
        self.fanout_stall_s = 0.0  # cumulative feed backpressure

    # -- local fan-out -----------------------------------------------------
    def _feed(self, payload) -> bool:
        """Push one chunk payload to the local fan-out, blocking on
        sub-worker backpressure (w-send credit gate). Stalls past
        _STALL_RECORD_S become flight evidence."""
        t0 = time.perf_counter()
        while not self._stop.is_set():
            try:
                self._feed_ep.send(payload, timeout=1.0)
                waited = time.perf_counter() - t0
                if waited > _STALL_RECORD_S:
                    self.fanout_stall_s += waited
                    FLIGHT.record("hier", "fanout_stall",
                                  wait_s=round(waited, 4),
                                  reason="local sub-workers saturated; "
                                         "feed blocked on credit")
                return True
            except TimeoutError:
                continue
            except OSError:
                return False
        return False

    # -- upstream fetch ----------------------------------------------------
    def _fetch_loop(self) -> None:
        ready = serialization.dumps(
            ("ready", self.ident, self._fiber_pid, self._host_key,
             "hier"))
        try:
            while not self._stop.is_set():
                self._up_task.send(ready)
                msg = serialization.loads(self._up_task.recv())
                if msg[0] == "exit":
                    self._draining.set()
                    return
                if msg[0] == "range":
                    for seq, base, payload in msg[1]:
                        with self._lock:
                            self._outstanding[(seq, base)] = payload
                        if not self._feed(payload):
                            return
                elif msg[0] == "task":
                    # Defensive: a master that doesn't speak ranges
                    # still hands a single envelope — feed it raw. The
                    # envelope seq/base ride inside the payload we were
                    # handed already decoded, so re-dumps it.
                    payload = serialization.dumps(msg)
                    with self._lock:
                        self._outstanding[(msg[1], msg[2])] = payload
                    if not self._feed(payload):
                        return
        except BaseException:
            # Upstream gone (or decode failure): the master's death
            # backstop owns the pending chunks; tear down locally.
            self._failed.set()
            self._draining.set()

    # -- result aggregation ------------------------------------------------
    def _flush(self, batch: List[Tuple[int, int, list]]) -> None:
        if not batch:
            return
        try:
            self._up_result.send(serialization.dumps(
                ("rbatch", batch, self.ident)))
        except OSError:
            self._failed.set()
            self._draining.set()

    def _flush_fwd(self, fwd: List[bytes]) -> None:
        if not fwd:
            return
        try:
            self._up_result.send(serialization.dumps(
                ("fbatch", fwd, self.ident)))
        except OSError:
            self._failed.set()
            self._draining.set()

    def _result_loop(self) -> None:
        from fiber_tpu_torch.transport.tcp import TransportClosed

        batch: List[Tuple[int, int, list]] = []
        batch_bytes = 0
        first_t = 0.0
        fwd: List[bytes] = []
        fwd_bytes = 0
        fwd_t = 0.0
        while not self._stop.is_set():
            try:
                data = self._results_local.recv(timeout=_BATCH_AGE_S)
            except TimeoutError:
                if batch:
                    self._flush(batch)
                    batch, batch_bytes = [], 0
                if fwd and time.perf_counter() - fwd_t >= _FWD_AGE_S:
                    self._flush_fwd(fwd)
                    fwd, fwd_bytes = [], 0
                continue
            except (TransportClosed, OSError):
                break
            try:
                msg = serialization.loads(data)
                kind = msg[0]
                if kind == "result":
                    _, seq, base, values, _cid = msg
                    with self._lock:
                        self._outstanding.pop((seq, base), None)
                    if not batch:
                        first_t = time.perf_counter()
                    batch.append((seq, base, values))
                    batch_bytes += len(data)
                    # The `not self._outstanding` leg: nothing left
                    # in flight locally means nothing can join this
                    # batch but the age timer — flush now. Streaming
                    # maps with tight admission windows live on this:
                    # the master releases window slots per rbatch, so
                    # a held batch is held backpressure.
                    if (len(batch) >= _BATCH_CHUNKS
                            or batch_bytes >= _BATCH_BYTES
                            or not self._outstanding
                            or time.perf_counter() - first_t
                            >= _BATCH_AGE_S):
                        self._flush(batch)
                        batch, batch_bytes = [], 0
                elif kind == "storemiss":
                    _, seq, base, n, _cid = msg
                    with self._lock:
                        self._outstanding.pop((seq, base), None)
                    # Rewritten to OUR ident: the master's pending table
                    # and scheduler know this ident, not the child's.
                    self._up_result.send(serialization.dumps(
                        ("storemiss", seq, base, n, self.ident)))
                elif kind in _FWD_KINDS:
                    # Per-chunk telemetry from the children: batched
                    # into one ("fbatch", ...) frame upstream so master
                    # ingress scales with hosts, not chunks.
                    if not fwd:
                        fwd_t = time.perf_counter()
                    fwd.append(bytes(data))
                    fwd_bytes += len(data)
                    if (len(fwd) >= _FWD_FRAMES
                            or fwd_bytes >= _FWD_BYTES
                            or time.perf_counter() - fwd_t
                            >= _FWD_AGE_S):
                        self._flush_fwd(fwd)
                        fwd, fwd_bytes = [], 0
                else:
                    # Anything else is forwarded verbatim — the
                    # master's result loop already speaks it.
                    self._up_result.send(data)
            except OSError:
                self._failed.set()
                self._draining.set()
                break
            except Exception:
                logger.exception(
                    "hier: dropping malformed local result frame")
        self._flush(batch)
        self._flush_fwd(fwd)

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> None:
        import multiprocessing

        from fiber_tpu_torch import config as fconfig
        from fiber_tpu_torch import process as fprocess
        from fiber_tpu_torch.pool import _SUBWORKER_RECYCLE, _subworker_main
        from fiber_tpu_torch.testing import chaos
        from fiber_tpu_torch.transport.tcp import (
            Device, Endpoint, connect_transport)

        cfg = fconfig.get()
        self._fiber_pid = fprocess.current_process().pid or os.getpid()
        self._host_key = local_host_key()

        # Local fan-out: the C++ epoll pump where available (TCP engine
        # only — under shm the Python endpoints negotiate per-channel
        # rings, which the TCP-only pump would bypass).
        self._device = None
        use_pump = False
        if str(getattr(cfg, "transport_io", "selector")) != "shm":
            try:
                from fiber_tpu_torch._native import available

                use_pump = available()
            except Exception:
                use_pump = False
        if use_pump:
            self._device = Device("r", "w", "127.0.0.1")
            child_task_addr = self._device.out_addr
            self._feed_ep = connect_transport(
                "w", self._device.in_addr, native=False)
        else:
            self._feed_ep = Endpoint("w")
            child_task_addr = self._feed_ep.bind("127.0.0.1")
        self._results_local = Endpoint("r")
        child_result_addr = self._results_local.bind("127.0.0.1")

        # Upstream: REQ handout channel + result stream, exactly the
        # endpoints a direct resilient worker would hold.
        self._up_result = connect_transport("w", self._result_addr)
        self._up_task = connect_transport("req", self._task_addr)

        heartbeater = None
        hb_interval = float(cfg.heartbeat_interval or 0)
        if hb_interval > 0:
            from fiber_tpu_torch.health import Heartbeater

            hb_payload = serialization.dumps(("hb", self.ident))

            def _beat() -> None:
                self._up_result.send(hb_payload, timeout=hb_interval)

            heartbeater = Heartbeater(
                _beat, hb_interval, gate=chaos.heartbeats_allowed,
            ).start()

        ctx = multiprocessing.get_context("fork")

        def spawn(i: int):
            cid = uuid.uuid4().bytes
            p = ctx.Process(
                target=_subworker_main,
                args=(cid, child_task_addr, child_result_addr, False,
                      self._initializer, self._initargs,
                      self._maxtasksperchild, self._store_addr),
                name=f"fiber-torch-hier-sub-{i}",
                daemon=True,
            )
            p.start()
            return cid, p

        children = {cid: (p, time.monotonic())
                    for cid, p in (spawn(i)
                                   for i in range(self._n_local))}
        FLIGHT.record("hier", "submaster_up", workers=self._n_local,
                      pump="native" if use_pump else "python")

        result_thread = threading.Thread(
            target=self._result_loop, name="fiber-torch-hier-results",
            daemon=True)
        result_thread.start()
        fetch_thread = threading.Thread(
            target=self._fetch_loop, name="fiber-torch-hier-fetch",
            daemon=True)
        fetch_thread.start()

        fail_streak = 0
        try:
            while not self._draining.is_set():
                time.sleep(0.05)
                for cid, (p, born) in list(children.items()):
                    code = p.exitcode
                    if code is None:
                        continue
                    del children[cid]
                    p.join()
                    if code == 0 or self._draining.is_set():
                        continue
                    if code != _SUBWORKER_RECYCLE:
                        # Crash: whatever that child held (computing +
                        # granted) is gone — re-feed EVERY locally
                        # outstanding chunk (the fan-out doesn't track
                        # which child held what; duplicates dedup at
                        # the master's fill). Backoff on crash loops,
                        # same policy as the direct packing parent.
                        if time.monotonic() - born < 5.0:
                            fail_streak += 1
                        else:
                            fail_streak = 0
                        time.sleep(min(0.1 * (2 ** fail_streak), 2.0))
                        with self._lock:
                            resub = list(self._outstanding.values())
                        FLIGHT.record(
                            "hier", "sub_respawn", code=code,
                            refed=len(resub),
                            reason="local sub-worker died; re-fed its "
                                   "host's outstanding chunks")
                        new_cid, new_p = spawn(len(children))
                        children[new_cid] = (new_p, time.monotonic())
                        for payload in resub:
                            if not self._feed(payload):
                                break
                    else:
                        new_cid, new_p = spawn(len(children))
                        children[new_cid] = (new_p, time.monotonic())

            # Drain: on a clean exit the master has every result (it
            # only releases drained pools), so the children are idle —
            # push exit envelopes until they're all gone. On upstream
            # failure there is nobody to report to: terminate hard, the
            # master's death path owns the pending chunks.
            if self._failed.is_set():
                for cid, (p, _) in children.items():
                    try:
                        p.terminate()
                    except Exception:
                        pass
            else:
                exit_payload = serialization.dumps(("exit",))
                deadline = time.monotonic() + 30.0
                while children and time.monotonic() < deadline:
                    for cid, (p, _) in list(children.items()):
                        if p.exitcode is not None:
                            del children[cid]
                            p.join()
                    if not children:
                        break
                    try:
                        self._feed_ep.send(exit_payload, timeout=0.2)
                    except (TimeoutError, OSError):
                        time.sleep(0.05)
                for cid, (p, _) in children.items():
                    logger.warning(
                        "hier: sub-worker did not exit; terminating")
                    try:
                        p.terminate()
                    except Exception:
                        pass
            for cid, (p, _) in children.items():
                p.join(10)
        finally:
            self._stop.set()
            if heartbeater is not None:
                heartbeater.stop()
            result_thread.join(5)
            for ep in (self._up_task, self._up_result, self._feed_ep,
                       self._results_local):
                try:
                    ep.close()
                except Exception:
                    pass
