"""The device plane's benchmark: ``bench.py``'s device modes on the card.

Run as a module; each mode prints one JSON line (``--ici`` three)::

    python -m fiber_tpu_torch.bench                # ES evals/s + the pool leg
    python -m fiber_tpu_torch.bench --pixels       # ES on the pixel chase
    python -m fiber_tpu_torch.bench --biped        # ES on the biped course
    python -m fiber_tpu_torch.bench --poet         # POET co-evolution
    python -m fiber_tpu_torch.bench --attention    # ring attention tokens/s
    python -m fiber_tpu_torch.bench --lm           # TinyLM training tokens/s
    python -m fiber_tpu_torch.bench --ici          # the store's device tier

The counterpart of the JAX package's ``bench.py`` for those modes, with
its workloads, defaults, timing and line keys. The workloads are the
port's entry points (``entry.py``'s ``_es_setup``, ``run_poet``,
``train_lm``) over a one-axis mesh with as many ranks as
:func:`~fiber_tpu_torch.parallel.mesh.default_mesh` (one unless the
``mesh_shape`` setting names more), on the card unless ``--device cpu``
asks for the CPU, where every kernel wrapper runs its plain version.

Differences from ``bench.py``:

* ``vs_baseline`` is null in every mode: ``bench.py`` divides by a
  per-chip share of a rate stated for a TPU pod, which the port keeps no
  figure of;
* no CPU fallback: a card that is missing or hangs gives a line with
  ``value`` 0.0 and ``error`` (exit 1; 2 after ``--init-timeout``);
* a leg that fails (the attention and LM kernel legs, the pool leg)
  keeps the headline, adds its ``*_error`` key, and the run exits 1;
* the kernel legs of ``--attention`` and ``--lm`` run at any rank count
  (``bench.py`` runs them on a one-device TPU only): every rank of the
  port's mesh sits on the one card, so a leg on one rank is a
  same-device comparison;
* the pool leg runs in the default mode only (``bench.py`` also runs it
  after ``--pixels`` and ``--biped``): it measures the host pool, not
  the env;
* every device mode's line carries ``launches``: the launches of each
  hand-written kernel during the run;
* ``bench.py``'s records (``--record``, the TPU run file, the tuned
  operating point) and its host-plane modes are not here; the
  host-plane modes are still to come.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import threading
import time

#: Max allowed fiber/mp wall ratio at the 1 ms-task point (the
#: reference's signature overhead benchmark); enforced under
#: ``FIBER_BENCH_ENFORCE``.
_POOL_1MS_BUDGET = 1.1
#: ``--ici``: the wire bytes every repeat resolution may cost in all
#: (protocol noise, not a payload), and the wall factor by which the
#: tier-on broadcast must beat the tier-off re-transfer.
_ICI_REPEAT_WIRE_MAX = 4096
_ICI_WALL_RATIO_FLOOR = 1.3

#: timed calls of ``--attention`` and timed steps of ``--lm``, after one
#: warm-up each
ITERS = 5
#: the windowed flash leg's window
FLASH_WINDOW = 1024
#: largest max abs difference of a kernel leg from the headline output
LEG_TOL = 5e-2
#: ``--poet``: ES steps a pair a round, and the most pairs
POET_ES_STEPS = 4
POET_MAX_PAIRS = 6

HOST_PLANE_MODES = ("--store", "--telemetry", "--accounting", "--sched",
                    "--autonomy", "--transport", "--cluster", "--recovery",
                    "--scale", "--stream", "--serve", "--slo")


def _round_mfu(value):
    """mfu fields are fractions of peak spanning ~1e-7 (branchy ES eval
    loops) to ~0.5 (flash attention): 4 significant figures keep both
    regimes readable; fixed decimals would collapse the small ones to
    0.0. None (unknown peak, e.g. the CPU) passes through."""
    return None if value is None else float(f"{value:.4g}")


def _emit(result: dict) -> None:
    print(json.dumps(result), flush=True)


def _watchdog(seconds: float, payload: dict):
    """Prints ``payload`` with ``value`` 0.0 (and an ``error``) and ends
    the process with exit code 2 unless cancelled within ``seconds``: a
    hung card still gives a line."""

    def fire():
        _emit({**payload, "value": 0.0,
               "error": payload.get("error") or "timed out"})
        os._exit(2)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    return timer


@contextlib.contextmanager
def _armed(seconds: float, payload: dict):
    timer = _watchdog(seconds, payload)
    try:
        yield
    finally:
        timer.cancel()


def _kernels():
    """Every kernel wrapper of the port, each with its launch count."""
    from fiber_tpu_torch.ops import dma_ring
    from fiber_tpu_torch.ops import flash_attention as fa

    return (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
            dma_ring.ring_exchange)


def _launches(before=None) -> dict:
    """Each kernel's launches so far, less ``before``'s."""
    before = before or {}
    return {k.__name__: k.launches - before.get(k.__name__, 0)
            for k in _kernels()}


def _bench_mesh(dev):
    """``bench.py``'s ``Mesh(devices, ("pool",))``: one axis with as many
    ranks as the default mesh, on ``dev``."""
    from fiber_tpu_torch.parallel.mesh import default_mesh, make_mesh

    return make_mesh(dev, n=default_mesh(dev).n_dev)


# -- ES: the default mode, --pixels, --biped ------------------------------

def _es_bench(args, dev, metric: str) -> dict:
    """OpenAI-ES (sigma 0.1, lr 0.03) on CartPole with an MLP (32, 32),
    or on the pixel chase or the biped: a warm-up ``run_fused`` of
    ``--gens`` generations (on CUDA it captures the generation's graph),
    then a timed one of ``--gens`` more, from the host clock to a device
    synchronise; ``--profile`` traces the timed run."""
    from fiber_tpu_torch.device import synchronize
    from fiber_tpu_torch.entry import _es_setup
    from fiber_tpu_torch.utils import flops as flopsmod
    from fiber_tpu_torch.utils.profiling import trace

    env = "pixels" if args.pixels else "biped" if args.biped else "cartpole"
    mesh = _bench_mesh(dev)
    with _armed(args.init_timeout, {"metric": metric, "unit": "evals/s",
                                    "vs_baseline": None,
                                    "error": "compile/warmup timed out"}):
        es, params, policy, env_name, steps = _es_setup(
            env, dev, args.pop, args.steps, 0.1, 0.03, 0, mesh=mesh)
        params, _ = es.run_fused(params, args.gens)
        synchronize(dev)
    prof = trace(args.profile) if args.profile else contextlib.nullcontext()
    with prof:
        t0 = time.perf_counter()
        params, stats = es.run_fused(params, args.gens)
        synchronize(dev)
        elapsed = time.perf_counter() - t0
    gen_flops = flopsmod.es_flops_per_gen(policy, env_name, steps,
                                          es.pop_size, policy.dim)
    evals_per_sec = es.pop_size * args.gens / elapsed
    model_fps = gen_flops * args.gens / elapsed
    return {
        "metric": metric,
        "value": round(evals_per_sec, 2),
        "unit": "evals/s",
        "vs_baseline": None,
        "pop_size": es.pop_size,
        "episode_steps": steps,
        "generations": args.gens,
        "n_devices": mesh.n_dev,
        "platform": dev.type,
        "env_steps_per_sec": round(evals_per_sec * steps, 1),
        "model_flops_per_sec": round(model_fps, 1),
        "mfu": _round_mfu(flopsmod.mfu(model_fps, mesh.devices)),
        **flopsmod.peak_report(mesh.devices),
        "mean_fitness": float(stats[-1][0]),
        "rollout_unroll": 1,
        "policy_dtype": os.environ.get("FIBER_POLICY_DTYPE") or "float32",
    }


# -- --poet -----------------------------------------------------------------

def _poet_bench(args, dev) -> dict:
    """POET on ParamCartPole (MLP (16,)): ``--gens`` rounds of
    POET_ES_STEPS ES steps a pair, at most POET_MAX_PAIRS pairs, timed
    whole; evals counted as ``bench.py`` counts them."""
    from fiber_tpu_torch.entry import run_poet

    mesh = _bench_mesh(dev)
    history, evals, perf = run_poet(
        dev, pop=args.pop, max_steps=args.steps, iterations=args.gens,
        es_steps=POET_ES_STEPS, max_pairs=POET_MAX_PAIRS, ranks=mesh.n_dev)
    return {
        "metric": "poet_policy_evals_per_sec",
        "value": round(evals / perf["seconds"], 2),
        "unit": "evals/s",
        "vs_baseline": None,
        "iterations": args.gens,
        "pop_size": args.pop,
        "rollout_steps": args.steps,
        "platform": dev.type,
        "n_devices": mesh.n_dev,
        "model_flops_per_sec": round(perf["model_flops_per_sec"], 1),
        "mfu": _round_mfu(perf["mfu"]),
        "device_kind": perf["device_kind"],
        "peak_row": perf["peak_row"],
        "final_pairs": history[-1]["pairs"],
        "total_transfers": sum(h["transfers"] for h in history),
        "fitness_first_iter": round(history[0]["mean_fitness"], 2),
        "fitness_last_iter": round(history[-1]["mean_fitness"], 2),
        "history": history,
    }


# -- --attention ------------------------------------------------------------

def _timed_calls(fn, dev):
    """``fn()`` ITERS times: (the last output, the wall seconds to a
    device synchronise)."""
    from fiber_tpu_torch.device import synchronize

    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = fn()
    synchronize(dev)
    return out, time.perf_counter() - t0


def _attention_bench(args, dev) -> dict:
    """Exact causal attention over (S, 8, 64) bf16 at S = ``--seq``: the
    headline is ``ring_attention`` on the plain ``"xla"`` engine over
    the mesh, ITERS calls after a warm-up. Then three kernel legs, each
    first held to the headline's output within LEG_TOL: the flash kernel
    (``flash_fwd``) alone, with a FLASH_WINDOW-token window (held on the
    prefix that the window leaves whole), and as the ring's per-rank
    block. A failed leg becomes its ``*_error`` key."""
    import torch

    from fiber_tpu_torch.device import synchronize
    from fiber_tpu_torch.ops.flash_attention import flash_attention
    from fiber_tpu_torch.ops.ring_attention import ring_attention
    from fiber_tpu_torch.utils import flops as flopsmod

    mesh = _bench_mesh(dev)
    n = mesh.n_dev
    seq, heads, head_dim = args.seq, 8, 64
    seq = max(seq - seq % max(n, 1), n)
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(seq, heads, head_dim, generator=gen)
               .to(dev, torch.bfloat16) for _ in range(3))

    def ring(local="xla"):
        return ring_attention(q, k, v, mesh=mesh, causal=True, local=local)

    base = {"metric": "ring_attention_tokens_per_sec", "unit": "tokens/s",
            "vs_baseline": None}
    with torch.no_grad():
        with _armed(args.init_timeout,
                    {**base, "error": "attention compile/warmup timed out"}):
            out = ring()
            synchronize(dev)
        out, elapsed = _timed_calls(ring, dev)
        ref = out.float()
        attn_flops = flopsmod.attention_flops(seq, heads, head_dim,
                                              causal=True)
        attn_fps = attn_flops * ITERS / elapsed
        result = {
            **base,
            "value": round(seq * ITERS / elapsed, 1),
            "seq_len": seq,
            "heads": heads,
            "head_dim": head_dim,
            "causal": True,
            "dtype": "bfloat16",
            "n_devices": n,
            "platform": dev.type,
            "attn_flops_per_sec": round(attn_fps, 1),
            "mfu": _round_mfu(flopsmod.mfu(attn_fps, mesh.devices)),
            **flopsmod.peak_report(mesh.devices),
        }

        def leg(name, fn, rows=None):
            """``fn``'s warm-up output held to the headline's (on its
            first ``rows`` rows), then ITERS timed calls: (max abs error,
            seconds)."""
            with _armed(args.init_timeout,
                        {**result, "error": f"{name} leg timed out"}):
                got = fn()
                synchronize(dev)
            err = float((got.float()[:rows] - ref[:rows]).abs().max())
            if not err <= LEG_TOL:
                raise RuntimeError(f"{name} mismatch: {err}")
            return err, _timed_calls(fn, dev)[1]

        try:
            err, secs = leg("flash", lambda: flash_attention(
                q, k, v, causal=True))
            result["flash_tokens_per_sec"] = round(seq * ITERS / secs, 1)
            result["flash_speedup"] = round(elapsed / secs, 3)
            result["flash_max_err_vs_xla"] = err
            result["flash_mfu"] = _round_mfu(flopsmod.mfu(
                attn_flops * ITERS / secs, mesh.devices))
        except Exception as err:  # noqa: BLE001 - the headline survives
            result["flash_error"] = repr(err)
        try:
            win = FLASH_WINDOW
            err, secs = leg("windowed-flash", lambda: flash_attention(
                q, k, v, causal=True, window=win), rows=win)
            w_flops = flopsmod.attention_flops(seq, heads, head_dim,
                                               causal=True, window=win)
            result["flash_window"] = win
            result["flash_window_tokens_per_sec"] = round(
                seq * ITERS / secs, 1)
            result["flash_window_prefix_err"] = err
            result["flash_window_mfu"] = _round_mfu(flopsmod.mfu(
                w_flops * ITERS / secs, mesh.devices))
        except Exception as err:  # noqa: BLE001
            result["flash_window_error"] = repr(err)
        try:
            err, secs = leg("ring-flash", lambda: ring("flash"))
            result["ring_flash_tokens_per_sec"] = round(
                seq * ITERS / secs, 1)
            result["ring_flash_speedup"] = round(elapsed / secs, 3)
            result["ring_flash_max_err_vs_xla"] = err
            result["ring_flash_mfu"] = _round_mfu(flopsmod.mfu(
                attn_flops * ITERS / secs, mesh.devices))
        except Exception as err:  # noqa: BLE001
            result["ring_flash_error"] = repr(err)
    return result


# -- --lm -------------------------------------------------------------------

def _lm_bench(args, dev) -> dict:
    """TinyLM (vocab 256, dim 256, 8 heads, 4 layers) training at S =
    ``--seq`` with AdamW 1e-3 (``train_lm``: one warm-up step, ITERS
    timed): the headline on the ring plane over the mesh, then the flash
    leg (the three flash kernels) on one rank of the same card."""
    from fiber_tpu_torch.entry import LM_WIDTHS, train_lm
    from fiber_tpu_torch.models.transformer import TinyLM
    from fiber_tpu_torch.utils import flops as flopsmod

    mesh = _bench_mesh(dev)
    n = mesh.n_dev
    seq = max(args.seq - args.seq % max(n, 1), n)
    base = {"metric": "lm_train_tokens_per_sec", "unit": "tokens/s",
            "vs_baseline": None}
    with _armed(args.init_timeout,
                {**base, "error": "lm compile/warmup timed out"}):
        losses, elapsed = train_lm(dev, seq=seq, steps=ITERS,
                                   attention="ring", ranks=n)
    # the count reads the model's widths only: a CPU copy holds them
    step_flops = flopsmod.tinylm_flops_per_step(
        TinyLM(**LM_WIDTHS, max_seq=seq, device="cpu"), seq, train=True)
    model_fps = step_flops * ITERS / elapsed
    result = {
        **base,
        "value": round(seq * ITERS / elapsed, 1),
        "seq_len": seq,
        "dim": LM_WIDTHS["dim"],
        "heads": LM_WIDTHS["heads"],
        "layers": LM_WIDTHS["layers"],
        "attention": "ring",
        "n_devices": n,
        "platform": dev.type,
        "final_loss": float(losses[-1]),
        "model_flops_per_step": round(step_flops, 1),
        "model_flops_per_sec": round(model_fps, 1),
        "mfu": _round_mfu(flopsmod.mfu(model_fps, mesh.devices)),
        **flopsmod.peak_report(mesh.devices),
    }
    try:
        with _armed(args.init_timeout,
                    {**result, "error": "flash leg timed out"}):
            flosses, fsecs = train_lm(dev, seq=seq, steps=ITERS,
                                      attention="flash")
        result["flash_tokens_per_sec"] = round(seq * ITERS / fsecs, 1)
        result["flash_train_speedup"] = round(elapsed / fsecs, 3)
        result["flash_final_loss"] = float(flosses[-1])
        result["flash_mfu"] = _round_mfu(flopsmod.mfu(
            step_flops * ITERS / fsecs, mesh.devices))
    except Exception as err:  # noqa: BLE001 - the headline survives
        result["flash_error"] = repr(err)
    return result


# -- the pool leg of the default mode ---------------------------------------

def _timed_task(duration):
    time.sleep(duration)
    return duration


def _dev_square(x):
    return x * x


def _pool_bench(dev) -> dict:
    """Host-plane ``Pool.map`` overhead against stdlib multiprocessing
    (4 workers, best of 3 interleaved, at 600 tasks of 1 ms and 200 of
    10 ms, on the local backend with ``worker_lite``), and the device
    path: ``@meta(device=True)`` of ``x * x`` over 4096 f32 items, its
    first call (cold) and then 5 timed calls. The task functions are
    looked up in this module by name, so that workers import them from
    the package even when the benchmark runs as ``__main__``."""
    import importlib
    import multiprocessing

    import numpy as np

    import fiber_tpu_torch
    from fiber_tpu_torch.meta import meta

    tasks = importlib.import_module("fiber_tpu_torch.bench")
    os.environ["FIBER_BACKEND"] = "local"
    out: dict = {}
    workers = 4

    def run_one(make_pool, n_tasks, duration):
        with make_pool(workers) as pool:
            pool.map(tasks._timed_task, [0.0] * workers)  # spin-up barrier
            t0 = time.perf_counter()
            pool.map(tasks._timed_task, [duration] * n_tasks)
            return time.perf_counter() - t0

    fiber_tpu_torch.init(worker_lite=True)
    for duration, n_tasks, tag in ((0.001, 600, "1ms"), (0.01, 200, "10ms")):
        fib = mp = None
        for _ in range(3):
            f = run_one(fiber_tpu_torch.Pool, n_tasks, duration)
            m = run_one(multiprocessing.get_context("spawn").Pool, n_tasks,
                        duration)
            fib = f if fib is None else min(fib, f)
            mp = m if mp is None else min(mp, m)
        out[f"pool_map_{tag}_tasks_per_sec"] = round(n_tasks / fib, 1)
        out[f"pool_map_{tag}_overhead_vs_mp"] = round(fib / mp, 3)
    out["pool_map_1ms_budget"] = _POOL_1MS_BUDGET
    out["pool_map_1ms_over_budget"] = bool(
        out["pool_map_1ms_overhead_vs_mp"] > _POOL_1MS_BUDGET)

    dev_square = meta(device=True)(tasks._dev_square)
    items = np.arange(4096.0, dtype=np.float32)
    with fiber_tpu_torch.Pool(device=dev) as pool:
        t0 = time.perf_counter()
        pool.map(dev_square, items)
        out["pool_map_device_cold_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 1)
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            pool.map(dev_square, items)
        out["pool_map_device_tasks_per_sec"] = round(
            len(items) * iters / (time.perf_counter() - t0), 1)
    return out


# -- --ici --------------------------------------------------------------------

def _ici_eval(params, x):
    """Per-item device eval against a broadcast param vector: one full
    reduction over params mixed with the item scalar. With the device
    tier on, ``params`` stays on the card across maps; off, every map
    copies it again."""
    return (params * params).sum() * 1e-6 + x


def _ici_bench(args, dev) -> list:
    """The store's device tier (the port's ``ici`` transfer site). Two
    arms:

    1. **repeat-resolution wire bytes**: an ``--ici-mb`` payload resolved
       ``--ici-gens`` times through the store plane with
       ``device=True``, a fresh client (no host copy) each generation:
       the first pays one wire fetch and one host-to-device copy, every
       repeat must come out of the device tier with no payload on the
       wire;
    2. **broadcast wall ratio**: ``--ici-gens`` device-path
       ``Pool.starmap`` maps of ``--ici-tasks`` items over the shared
       payload with the tier on (one copy, then reuse) and off (a copy
       every map), best of 3 interleaved, gated at
       ``_ICI_WALL_RATIO_FLOOR``.

    Returns the three lines (``ici_repeat_wire_bytes``,
    ``ici_broadcast_wall_ratio``, ``ici_gates``)."""
    import importlib

    import numpy as np

    import fiber_tpu_torch
    from fiber_tpu_torch import serialization
    from fiber_tpu_torch import store as storemod
    from fiber_tpu_torch.meta import meta
    from fiber_tpu_torch.store import LocalStore
    from fiber_tpu_torch.store.plane import StoreClient, StoreServer
    from fiber_tpu_torch.telemetry.device import DEVICE

    payload_mb = float(args.ici_mb)
    gens = max(2, int(args.ici_gens))
    tasks = int(args.ici_tasks)

    fiber_tpu_torch.init(store_enabled=True)
    storemod.reset()
    tier = storemod.device_store_tier()
    if tier is None:
        raise RuntimeError("the device store tier is disabled "
                           "(store_device_enabled=False?)")
    tier.device = dev
    arr = np.random.default_rng(7).standard_normal(
        int(payload_mb * (1 << 20) / 4)).astype(np.float32)

    def ici_site_bytes() -> int:
        site = DEVICE.snapshot()["transfers"].get("ici") or {}
        return int(site.get("bytes", 0))

    # -- arm 1: repeat-generation resolution --------------------------
    blob = serialization.dumps(arr)
    st = LocalStore(capacity_bytes=512 << 20)
    server = StoreServer(st, "127.0.0.1")
    ref = st.put_bytes(blob)
    wire_ref = type(ref)(ref.digest, ref.size, server.addr, True)
    ici_before = ici_site_bytes()
    client = StoreClient(LocalStore(capacity_bytes=512 << 20))
    first = client.resolve(wire_ref, device=True)
    client.close()
    served_first = server.stats()["bytes_served"]
    for _ in range(gens - 1):
        c = StoreClient(LocalStore(capacity_bytes=512 << 20))
        again = c.resolve(wire_ref, device=True)
        c.close()
        if again is None:
            raise RuntimeError("a repeat resolution returned nothing")
    served_total = server.stats()["bytes_served"]
    server.close()
    repeat_wire = served_total - served_first
    tstats = tier.stats()
    ici_bytes = ici_site_bytes() - ici_before
    lines = [{"metric": "ici_repeat_wire_bytes", "value": int(repeat_wire),
              "unit": "bytes", "budget": _ICI_REPEAT_WIRE_MAX,
              "generations": gens, "payload_mb": payload_mb,
              "first_gen_wire_bytes": int(served_first),
              "device_tier_hits": int(tstats.get("hits", 0)),
              "ici_transfer_bytes": int(ici_bytes),
              "payload_shape_ok": tuple(first.shape) == arr.shape,
              "payload_device": str(first.device),
              "platform": dev.type}]

    # -- arm 2: broadcast wall ratio, tier on vs off -------------------
    ev = meta(device=True)(importlib.import_module(
        "fiber_tpu_torch.bench")._ici_eval)
    items = [(arr, np.float32(i)) for i in range(tasks)]
    walls = {"on": None, "off": None}
    for _ in range(3):
        for mode in ("on", "off"):
            fiber_tpu_torch.init(store_device_enabled=(mode == "on"))
            with fiber_tpu_torch.Pool(2, device=dev) as pool:
                out = pool.starmap(ev, items)  # plan + gen-1 put
                t0 = time.perf_counter()
                for _ in range(gens):
                    out = pool.starmap(ev, items)
                wall = time.perf_counter() - t0
            if len(out) != tasks:
                raise RuntimeError(f"{len(out)} results of {tasks} tasks")
            walls[mode] = wall if walls[mode] is None \
                else min(walls[mode], wall)
    fiber_tpu_torch.init()
    ratio = walls["off"] / max(walls["on"], 1e-9)
    hits = int(tstats.get("hits", 0))
    lines.append({"metric": "ici_broadcast_wall_ratio",
                  "value": round(ratio, 3), "unit": "x vs tier-off",
                  "floor": _ICI_WALL_RATIO_FLOOR, "generations": gens,
                  "tasks": tasks, "payload_mb": payload_mb,
                  "wall_on_s": round(walls["on"], 4),
                  "wall_off_s": round(walls["off"], 4)})
    lines.append({"metric": "ici_gates",
                  "repeat_wire_bytes": int(repeat_wire),
                  "wire_budget": _ICI_REPEAT_WIRE_MAX,
                  "wall_ratio": round(ratio, 3),
                  "ratio_floor": _ICI_WALL_RATIO_FLOOR,
                  "device_tier_hits": hits,
                  "over_budget": bool(repeat_wire > _ICI_REPEAT_WIRE_MAX),
                  "under_floor": bool(ratio < _ICI_WALL_RATIO_FLOOR),
                  "tier_cold": bool(hits < gens - 1)})
    return lines


def _ici_rc(gates: dict) -> int:
    """1 when ``gates`` marks a gate missed (each said on stderr), else 0."""
    rc = 0
    if gates["over_budget"]:
        print(f"FAIL: repeat-generation wire bytes "
              f"{gates['repeat_wire_bytes']} exceed budget "
              f"{_ICI_REPEAT_WIRE_MAX}: repeats are not coming out of the "
              "device tier", file=sys.stderr)
        rc = 1
    if gates["tier_cold"]:
        print(f"FAIL: device tier hits {gates['device_tier_hits']} too few: "
              "repeat resolutions missed the tier", file=sys.stderr)
        rc = 1
    if gates["under_floor"]:
        print(f"FAIL: device-tier broadcast wall ratio "
              f"{gates['wall_ratio']:.2f}x below floor "
              f"{_ICI_WALL_RATIO_FLOOR}x", file=sys.stderr)
        rc = 1
    return rc


# -- the command ----------------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="python -m fiber_tpu_torch.bench",
        description="bench.py's device modes on the port: one JSON line "
                    "a mode (--ici: three)",
        epilog="bench.py's host-plane modes (" + " ".join(HOST_PLANE_MODES)
               + ") are still to come; --platform, --record and the "
                 "TPU records have no counterpart.")
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--pop", type=int, default=None,
                        help="population size (default 4096; 1024 with "
                             "--pixels)")
    parser.add_argument("--steps", type=int, default=None,
                        help="episode length (default 500; 400 with "
                             "--biped; the env max with --pixels)")
    parser.add_argument("--gens", type=int, default=10,
                        help="ES generations (POET iterations with "
                             "--poet)")
    parser.add_argument("--init-timeout", type=float, default=600.0,
                        help="seconds the card may take to set up and warm "
                             "up a mode before it prints an error line and "
                             "exits 2")
    parser.add_argument("--no-pool-bench", action="store_true",
                        help="skip the default mode's pool leg")
    for flag, text in (
            ("--poet", "POET co-evolution on ParamCartPole"),
            ("--pixels", "ES with a conv policy on the pixel chase"),
            ("--biped", "ES on the biped's flat course"),
            ("--attention", "causal ring attention tokens/s at --seq, "
                            "with the flash kernel legs"),
            ("--lm", "TinyLM training tokens/s at --seq, ring plane and "
                     "flash leg"),
            ("--ici", "the store's device tier: repeat resolutions and "
                      "the tier-on broadcast wall ratio")):
        parser.add_argument(flag, action="store_true", help=text)
    parser.add_argument("--seq", type=int, default=16384,
                        help="sequence length for --attention and --lm")
    parser.add_argument("--ici-mb", type=float, default=8.0,
                        help="broadcast payload size for --ici, MB")
    parser.add_argument("--ici-gens", type=int, default=4,
                        help="generations for --ici")
    parser.add_argument("--ici-tasks", type=int, default=16,
                        help="tasks per generation for --ici's wall arm")
    parser.add_argument("--profile", default="",
                        help="write a torch.profiler trace of the timed ES "
                             "section to this directory")
    return parser


def _metric(args) -> str:
    return ("poet_policy_evals_per_sec" if args.poet
            else "es_pixel_evals_per_sec" if args.pixels
            else "es_biped_evals_per_sec" if args.biped
            else "ring_attention_tokens_per_sec" if args.attention
            else "lm_train_tokens_per_sec" if args.lm
            else "ici_gates" if args.ici
            else "es_policy_evals_per_sec")


def _run(args, dev) -> list:
    """The chosen mode's lines."""
    if args.ici:
        return _ici_bench(args, dev)
    if args.poet:
        return [_poet_bench(args, dev)]
    if args.attention:
        return [_attention_bench(args, dev)]
    if args.lm:
        return [_lm_bench(args, dev)]
    result = _es_bench(args, dev, _metric(args))
    if not (args.pixels or args.biped or args.no_pool_bench):
        try:
            result.update(_pool_bench(dev))
        except Exception as err:  # noqa: BLE001 - the headline survives
            result["pool_bench_error"] = repr(err)
    return [result]


def main(argv=None) -> int:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.gens < 1:
        parser.error("--gens must be >= 1")
    if sum((args.poet, args.pixels, args.biped, args.attention, args.lm,
            args.ici)) > 1:
        parser.error("--poet/--pixels/--biped/--attention/--lm/--ici are "
                     "mutually exclusive")
    if not args.ici:
        if args.pop is not None and args.pop < 2:
            parser.error("--pop must be >= 2")
        if args.steps is not None and args.steps < 1:
            parser.error("--steps must be >= 1")
        if (args.attention or args.lm) and args.seq < 64:
            parser.error("--seq must be >= 64")
    if args.biped or args.poet:
        args.pop = args.pop or 4096
        args.steps = args.steps or (400 if args.biped else 500)
    elif not (args.pixels or args.attention or args.lm or args.ici):
        args.pop = args.pop or 4096
        args.steps = args.steps or 500
    fail = {"metric": _metric(args), "value": 0.0,
            "unit": ("tokens/s" if args.attention or args.lm
                     else "" if args.ici else "evals/s"),
            "vs_baseline": None}

    from fiber_tpu_torch import config

    saved_config = config.get().as_dict()
    saved_backend = os.environ.get("FIBER_BACKEND")
    try:
        with _armed(args.init_timeout, {
                **fail, "error": "device initialization timed out"}):
            import torch

            from fiber_tpu_torch.device import resolve_device

            dev = resolve_device(args.device)
            torch.empty(1, device=dev)
        before = _launches()
        lines = _run(args, dev)
        launches = _launches(before)
    except Exception as err:  # noqa: BLE001 - one line, whatever failed
        _emit({**fail, "error": repr(err)})
        return 1
    finally:
        config.init_from(saved_config)
        if saved_backend is None:
            os.environ.pop("FIBER_BACKEND", None)
        else:
            os.environ["FIBER_BACKEND"] = saved_backend
    for line in lines:
        line["launches"] = launches
        _emit(line)
    if args.ici:
        return _ici_rc(lines[-1])
    result = lines[0]
    errors = sorted(k for k in result if k.endswith("_error"))
    if errors:
        print(f"FAIL: {', '.join(errors)}", file=sys.stderr)
        return 1
    enforce = os.environ.get("FIBER_BENCH_ENFORCE", "").strip().lower()
    if (enforce not in ("", "0", "false", "no")
            and result.get("pool_map_1ms_over_budget")):
        print(f"FAIL: pool_map_1ms_overhead_vs_mp "
              f"{result['pool_map_1ms_overhead_vs_mp']} exceeds budget "
              f"{_POOL_1MS_BUDGET}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
