"""The port's device plane under the user API against the JAX package's,
on the CPU: ``@meta(device=True)`` maps through ``Pool``, the broadcast
split through the store's device tier, ``device_map``'s plan cache and
fingerprint pins, the ``DEVICE`` telemetry and the profiling mirrors.

JAX runs on its 8 virtual CPU devices; the port's pools are made with
``device="cpu"``. Inputs come from a numpy seed (CartPole start states
from JAX's own reset, as ``tests/test_torch_envs.py`` does).
"""

import contextlib
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

import jax

import fiber_tpu
from fiber_tpu import store as jax_store
from fiber_tpu.models import CartPole as JaxCartPole
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.parallel import dmap as jax_dmap
from fiber_tpu.telemetry.device import DEVICE as JAX_DEVICE

import fiber_tpu_torch
from fiber_tpu_torch import store
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.parallel import dmap
from fiber_tpu_torch.parallel.mesh import make_mesh
from fiber_tpu_torch.telemetry.device import DEVICE
from tests.test_torch_pool import bounded

STEPS = 80
N = 24

JAX_POL = JaxMLPPolicy(4, 2, hidden=(8,))
POL = MLPPolicy(4, 2, hidden=(8,))


@fiber_tpu.meta(device=True)
def jax_eval(theta, key):
    return JaxCartPole.rollout(JAX_POL.act, theta, key, max_steps=STEPS)


@fiber_tpu_torch.meta(device=True)
def torch_eval(theta, state):
    return CartPole.rollout(POL.act, theta[None], state[None],
                            max_steps=STEPS)[0]


def _pairs():
    rng = np.random.default_rng(0)
    thetas = (0.7 * rng.standard_normal((N, POL.dim))).astype(np.float32)
    keys = np.asarray(jax.random.split(jax.random.PRNGKey(1), N))
    states = np.asarray(jax.vmap(JaxCartPole.reset)(keys))
    return thetas, keys, states


@contextlib.contextmanager
def _pool(pkg):
    """A 2-process pool of either package (the port's maps on the CPU),
    terminated on the way out, so that a stuck call cannot stall the
    exit."""
    pool = pkg.Pool(2, **({"device": "cpu"} if pkg is fiber_tpu_torch
                          else {}))
    try:
        yield pool
    finally:
        pool.terminate()
        pool.join()


def _clear_tiers():
    for tier in (jax_store.device_store_tier(), store.device_store_tier()):
        if tier is not None:
            tier.clear()


# -- @meta(device=True) through the pool ---------------------------------

def test_device_starmap_of_cartpole_matches_the_jax_pool():
    """The same thetas and start states through ``fiber_tpu.Pool`` and
    ``fiber_tpu_torch.Pool(device="cpu")``: equal returns, exactly (as
    ``tests/test_torch_envs.py`` holds CartPole), and no worker process
    starts in either package."""
    thetas, keys, states = _pairs()
    with _pool(fiber_tpu) as jpool:
        want = bounded(lambda: jpool.starmap(jax_eval,
                                             list(zip(thetas, keys))))
        assert fiber_tpu.active_children() == []
    with _pool(fiber_tpu_torch) as pool:
        got = bounded(lambda: pool.starmap(torch_eval,
                                           list(zip(thetas, states))))
        assert fiber_tpu_torch.active_children() == []
    want = [float(x) for x in want]
    assert [float(x) for x in got] == want
    assert len(set(want)) > 3 and min(want) < STEPS


@fiber_tpu.meta(device=True)
def jax_project(w, x):
    import jax.numpy as jnp

    return jnp.tanh(x @ w).sum()


@fiber_tpu_torch.meta(device=True)
def torch_project(w, x):
    return torch.tanh(x @ w).sum()


@pytest.mark.parametrize("rows", [160, 2], ids=["above_floor", "below"])
def test_broadcast_split_through_the_device_tier_matches(rows):
    """A shared (rows, 128) f32 weight, the identical object in every
    item: at 80 KB it is lifted through each package's device tier once
    and the two repeats hit it (``put_dedup_hits``); at 1 KB, below the
    64 KB floor, neither tier sees it. Returns agree within 1e-5 (the two
    packages sum the products in another order)."""
    rng = np.random.default_rng(2)
    w = rng.standard_normal((rows, 128)).astype(np.float32) / 16
    xs = rng.standard_normal((8, rows)).astype(np.float32)
    _clear_tiers()
    stats = {}
    outs = {}
    for name, pkg, fn, mod in (("jax", fiber_tpu, jax_project, jax_store),
                               ("torch", fiber_tpu_torch, torch_project,
                                store)):
        with _pool(pkg) as pool:
            outs[name] = [bounded(lambda: pool.starmap(
                fn, [(w, x) for x in xs])) for _ in range(3)]
        tier = mod.device_store_tier()
        stats[name] = {k: tier.stats()[k]
                       for k in ("puts", "put_dedup_hits", "entries")}
    _clear_tiers()
    want = {"puts": 1, "put_dedup_hits": 2, "entries": 1} if rows == 160 \
        else {"puts": 0, "put_dedup_hits": 0, "entries": 0}
    assert stats["jax"] == stats["torch"] == want
    for got, ref in zip(outs["torch"], outs["jax"]):
        assert np.abs(np.asarray(got, np.float64)
                      - np.asarray(ref, np.float64)).max() <= 1e-5


def test_a_tensor_on_the_device_is_broadcast_without_the_tier():
    """A tensor already on the pool's device goes in as a broadcast
    argument as it is: no digest, no tier put, no transfer of it."""
    w = torch.from_numpy(
        np.random.default_rng(3).standard_normal((160, 128)).astype(
            np.float32) / 16)
    xs = np.random.default_rng(4).standard_normal((8, 160)).astype(
        np.float32)
    _clear_tiers()
    fiber_tpu_torch.init()
    DEVICE.clear()
    with _pool(fiber_tpu_torch) as pool:
        split = pool._device_broadcast_split([(w, x) for x in xs], True)
        got = bounded(lambda: pool.starmap(torch_project,
                                           [(w, x) for x in xs]))
    assert split[1][0] is w and split[2] == (0,)
    assert store.device_store_tier().stats()["puts"] == 0
    assert "ici" not in DEVICE.snapshot()["transfers"]
    want = torch.tanh(torch.from_numpy(xs) @ w).sum(-1)  # vmap's batch
    assert [float(v) for v in got] == want.tolist()


def test_a_closed_pool_raises_at_the_submit_site():
    """As ``tests/test_device.py`` holds the JAX package's pool."""
    for pkg, fn, item, kwargs in (
            (fiber_tpu, jax_project, np.float32(1), {}),
            (fiber_tpu_torch, torch_project, np.float32(1),
             {"device": "cpu"})):
        pool = pkg.Pool(2, **kwargs)
        pool.close()
        with pytest.raises(ValueError, match="Pool not running"):
            pool.map(fn, [item])
        with pytest.raises(ValueError, match="Pool not running"):
            pool.starmap(fn, [(item, item)])
        pool.join()


def test_device_maps_and_their_mfu_are_accounted():
    """A map of a ``@meta(device=True, flops=...)`` function: the pool
    bills its FLOPs and notes them with ``DEVICE``; the MFU is None on
    the CPU in both packages."""
    fiber_tpu_torch.init()
    DEVICE.clear()

    @fiber_tpu_torch.meta(device=True, flops=10.0)
    def f(x):
        return x * 2

    with _pool(fiber_tpu_torch) as pool:
        got = bounded(lambda: pool.map(f, np.arange(6.0)))
    assert [float(v) for v in got] == [0.0, 2.0, 4.0, 6.0, 8.0, 10.0]
    mfu = DEVICE.snapshot()["mfu"]
    assert mfu["items"] == 6 and mfu["flops_per_sec"] > 0
    assert mfu["mfu"] is None


# -- device_map's plan cache ----------------------------------------------

def square(x):
    return x * x


def _make(i):
    def f(x):
        return x + i
    return f


def _cache_walk(pkg_dmap, device_ctl, plan):
    """One sequence of plan constructions; what the cache did."""
    pkg_dmap.clear_device_map_cache()
    device_ctl.clear()
    trace = {}
    first = plan(square)._compiled_or_mapped()
    trace["named_hit"] = plan(square)._compiled_or_mapped() is first
    for _ in range(3):
        plan(lambda x: x - 1)
    fp = pkg_dmap._fingerprint(square, plan.mesh)
    trace["fingerprint"] = fp
    trace["pinned_now"] = pkg_dmap.pin_fingerprint(fp.split("@")[0])
    for i in range(140):
        plan(_make(i))
    with pkg_dmap._cache_lock:
        cached = list(pkg_dmap._compile_cache)
    trace["entries"] = len(cached)
    trace["square_survives"] = any(k[0] is square for k in cached)
    trace["lambdas_left"] = sum(
        1 for k in cached if k[0].__name__ == "<lambda>")
    trace["pins"] = pkg_dmap.pinned_fingerprints()
    counts = device_ctl.snapshot()["compile_fingerprints"]
    trace["notes"] = sorted(
        (fp.split(__name__ + ".")[-1], n) for fp, n in counts.items()
        if fp.startswith(__name__ + "."))
    pkg_dmap.unpin_fingerprint(fp.split("@")[0])
    trace["pins_after_unpin"] = pkg_dmap.pinned_fingerprints()
    pkg_dmap.clear_device_map_cache()
    return trace


class _JaxPlans:
    def __init__(self):
        from jax.sharding import Mesh

        self.mesh = Mesh(np.asarray(jax.devices()[:1]), ("pool",))

    def __call__(self, fn):
        plan = jax_dmap.DeviceMapPlan(fn, mesh=self.mesh)
        plan._compiled_or_mapped = lambda: plan._compiled
        return plan


class _TorchPlans:
    def __init__(self):
        self.mesh = make_mesh("cpu", n=1)

    def __call__(self, fn):
        plan = dmap.DeviceMapPlan(fn, mesh=self.mesh)
        plan._compiled_or_mapped = lambda: plan._mapped
        return plan


def test_plan_cache_hits_misses_pins_and_evictions_match_jax():
    """Named functions hit; a fresh lambda each call misses each time
    (and notes one fingerprint three times, the storm signal); a pin
    keeps its entry through 140 more functions, which evict everything
    unpinned past 128 entries. Both packages count the same."""
    fiber_tpu.init()
    fiber_tpu_torch.init()
    want = _cache_walk(jax_dmap, JAX_DEVICE, _JaxPlans())
    got = _cache_walk(dmap, DEVICE, _TorchPlans())
    assert got == want
    assert got["named_hit"] and got["square_survives"]
    assert got["entries"] == 128 and got["lambdas_left"] == 0
    assert got["notes"] == [
        ("_cache_walk.<locals>.<lambda>@(('pool', 1),)", 3),
        ("_make.<locals>.f@(('pool', 1),)", 140),
        ("square@(('pool', 1),)", 1)]


def test_device_map_results_hold_through_the_cache():
    """A cached plan computes what a fresh one does, against JAX."""
    dmap.clear_device_map_cache()
    xs = np.random.default_rng(5).standard_normal(13).astype(np.float32)
    for _ in range(2):
        got = dmap.device_map(square, xs, device="cpu")
        want = jax_dmap.device_map(square, xs)
        assert [float(v) for v in got] == [float(v) for v in want]
    dmap.clear_device_map_cache()


# -- DEVICE on the CPU ----------------------------------------------------

def test_snapshot_is_null_safe_and_initializes_no_cuda(monkeypatch):
    """With CUDA not initialized, the probes read no device: any call
    into the allocator or the device list would raise here."""
    fiber_tpu_torch.init()

    def refuse(*_a, **_k):
        raise AssertionError("a probe touched CUDA")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name in ("current_device", "memory_allocated", "mem_get_info",
                 "init", "device_count"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    DEVICE.update_gauges()
    snap = DEVICE.snapshot()
    assert snap["hbm"] == {"bytes_in_use": None, "bytes_limit": None}
    assert snap["live_arrays"] == {"count": None, "bytes": None}
    assert snap["platform"] is None and snap["jax_monitoring"] is False
    assert DEVICE.install_listeners() is False
    json.dumps(snap)


def test_snapshot_reads_cuda_once_initialized(monkeypatch):
    """Where CUDA is initialized the snapshot reads the allocator and the
    card's capacity, and names the platform ``gpu``."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 3 << 20)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda d: (70 << 30, 80 << 30))
    fiber_tpu_torch.init()
    DEVICE.update_gauges()
    snap = DEVICE.snapshot()
    assert snap["platform"] == "gpu"
    assert snap["hbm"] == {"bytes_in_use": 3 << 20, "bytes_limit": 80 << 30}
    assert snap["live_arrays"] == {"count": None, "bytes": 3 << 20}
    from fiber_tpu_torch.telemetry.monitor import _hbm_usage

    assert _hbm_usage() == (3 << 20, 80 << 30)
    monkeypatch.undo()
    DEVICE.clear()


def test_exit_waits_for_a_probe_inside_cuda_and_stops_the_rest(
        monkeypatch):
    """``_stop_cuda_probes`` (run by ``atexit``, before Python finalizes)
    waits for a probe that is inside ``torch.cuda`` and lets no probe
    enter it again: the monitor sampler is a daemon thread, and one
    still in a torch call when finalization begins aborts the process
    (exit -6)."""
    from fiber_tpu_torch.telemetry import device as devmod

    inside, leave = threading.Event(), threading.Event()
    calls = []

    def slow_mem_get_info(d):
        calls.append(d)
        inside.set()
        leave.wait(5)
        return (70 << 30, 80 << 30)

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 3 << 20)
    monkeypatch.setattr(torch.cuda, "mem_get_info", slow_mem_get_info)
    monkeypatch.setattr(devmod, "_cuda_probes_stopped", False)
    probe = threading.Thread(target=devmod._hbm_stats)
    probe.start()
    assert inside.wait(5)
    threading.Timer(0.2, leave.set).start()
    devmod._stop_cuda_probes(wait_s=5)
    assert leave.is_set(), "the stop did not wait for the probe"
    probe.join(5)
    assert devmod._devices() is None
    assert devmod._hbm_stats() == {"bytes_in_use": None,
                                   "bytes_limit": None}
    assert len(calls) == 1


_PROBING_AT_EXIT = """
import sys, threading, time
import torch
from fiber_tpu_torch.telemetry.device import DEVICE
a = torch.randn(600, 600)
torch.cuda.is_initialized = lambda: True
torch.cuda.current_device = lambda: 0
torch.cuda.memory_allocated = lambda d: 0
def mem_get_info(d):
    torch.mm(a, a)  # releases the GIL, as cudaMemGetInfo's binding does
    return (0, 1)
torch.cuda.mem_get_info = mem_get_info
DEVICE.enabled = True
def sample():
    while True:
        DEVICE.update_gauges()
threading.Thread(target=sample, daemon=True).start()
time.sleep(0.2)
"""


def test_a_process_exits_cleanly_while_the_sampler_probes_cuda():
    """A process whose daemon thread probes the device gauges without
    pause, each probe inside a torch call that releases the GIL, exits
    0. Without the exit-time stop it aborts at finalization ("terminate
    called without an active exception"), as a ring rank on the card
    once did. Three runs, about 3 s each."""
    import os
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    for _ in range(3):
        done = subprocess.run([sys.executable, "-c", _PROBING_AT_EXIT],
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert done.returncode == 0, done.stderr[-2000:]


def test_dmap_transfer_is_accounted_with_the_batch_bytes():
    """16 float64 items: 128 host bytes in both packages (JAX's 8-device
    mesh needs no padding at 16); a batch already on the device moves 0
    bytes, and the fingerprint is noted once across two calls."""
    fiber_tpu.init()
    fiber_tpu_torch.init()

    def triple(x):
        return x * 3

    JAX_DEVICE.clear()
    DEVICE.clear()
    for _ in range(2):
        jax_dmap.device_map(triple, np.arange(16.0))
        dmap.device_map(triple, np.arange(16.0), device="cpu")
    mine = DEVICE.snapshot()
    assert mine["transfers"]["dmap"]["count"] == 2
    assert mine["transfers"]["dmap"]["bytes"] \
        == JAX_DEVICE.snapshot()["transfers"]["dmap"]["bytes"] == 2 * 128
    assert sum(n for fp, n in mine["compile_fingerprints"].items()
               if "triple" in fp) == 1
    dmap.device_map(triple, torch.arange(16.0), device="cpu")
    assert DEVICE.snapshot()["transfers"]["dmap"]["bytes"] == 2 * 128


def test_note_compile_feeds_the_recompile_storm_rule():
    """As ``tests/test_device_telemetry.py`` holds the JAX package's:
    three compiles of one fingerprint in the window raise
    ``recompile_storm`` once; a drained window clears it."""
    from fiber_tpu_torch import config
    from fiber_tpu_torch.telemetry.flightrec import FLIGHT
    from fiber_tpu_torch.telemetry.monitor import AnomalyWatchdog

    fiber_tpu_torch.init(anomaly_recompile_count=3,
                         anomaly_recompile_window_s=30.0)
    try:
        DEVICE.clear()
        dog = AnomalyWatchdog()
        dog.configure(config.get())
        sample = {"wall": time.time(), "mono": time.monotonic(),
                  "tasks_per_s": 0.0, "inflight": 0.0, "queue_depth": 0.0,
                  "heartbeat_age_s": 0.0, "tx_queue_bytes": 0.0}
        DEVICE.note_compile("shape-churn")
        DEVICE.note_compile("shape-churn")
        dog.observe(sample)
        assert "recompile_storm" not in dog.snapshot()["active"]
        DEVICE.note_compile("shape-churn")
        assert DEVICE.recompile_state()["storm"] is True
        dog.observe(sample)
        active = dog.snapshot()["active"]
        assert active["recompile_storm"]["count"] == 3
        kinds = {(e["plane"], e["kind"]) for e in FLIGHT.snapshot()}
        assert ("monitor", "recompile_storm") in kinds
        DEVICE._recompiles.clear()
        dog.observe(sample)
        assert "recompile_storm" not in dog.snapshot()["active"]
    finally:
        fiber_tpu_torch.init(anomaly_recompile_count=4,
                             anomaly_recompile_window_s=30.0)
        DEVICE.clear()


# -- the profiling mirrors ------------------------------------------------

def test_profiling_hooks_report_to_telemetry(tmp_path):
    """``trace`` notes its capture with ``DEVICE``, ``annotate`` records a
    telemetry span, and ``global_timer`` mirrors into the registry's
    ``timer_seconds`` histogram, as in the JAX package."""
    from fiber_tpu_torch import telemetry
    from fiber_tpu_torch.telemetry import tracing
    from fiber_tpu_torch.utils import profiling

    fiber_tpu_torch.init()
    DEVICE.clear()
    tracing.SPANS.clear()
    before = time.time()
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("mirrored-region"):
            torch.arange(8.0).sum()
    noted = DEVICE.last_xla_trace()
    assert noted[0] == str(tmp_path / "t") and noted[1] >= before - 1
    spans = [s for s in tracing.SPANS.snapshot()
             if s["name"] == "mirrored-region"]
    assert len(spans) == 1 and spans[0]["kind"] == "torch.annotation"
    with profiling.timed("mirror-section"):
        pass
    hist = telemetry.REGISTRY.snapshot()["timer_seconds"]
    assert any("section=mirror-section" in k for k in hist["series"])
    profiling.global_timer.reset()
    assert "torch" in sys.modules
