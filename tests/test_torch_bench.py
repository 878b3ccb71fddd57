"""The port's benchmark command (``python -m fiber_tpu_torch.bench``)
against the JAX package's ``bench.py``, on the CPU.

* For each of the six device modes at tiny flags, ``bench.py`` runs in a
  subprocess (``--platform cpu``, one CPU device, a temporary working
  directory, never ``--record``) and the port's ``main`` runs in process
  with ``--device cpu``: the port's line carries every key of
  ``bench.py``'s (less the ``*_error`` keys of the legs that ``bench.py``
  runs only on a TPU, plus those legs' own keys), the configuration keys
  are equal, and ``--lm``'s model FLOPs a step are ``bench.py``'s.
* The port's numbers are the port's entry functions' at the same widths
  and seeds (``run_es``, ``run_poet``, ``train_lm``), its rate fields
  ``utils/flops``'s, and the attention legs within 5e-2 of the headline.
* Failures: ``--device cuda`` without a card, a leg made to raise, a
  watchdog that fires, ``FIBER_BENCH_ENFORCE`` over budget.
* The default mode's pool leg, and ``--ici`` against ``bench.py --ici``.

``bench.py`` takes 5 to 25 s a mode here (most of it JAX's start-up
and compiles); the port's runs take a few seconds each.
"""

import contextlib
import functools
import importlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

from fiber_tpu_torch import bench
from fiber_tpu_torch.entry import (
    flagship_policy,
    make_poet,
    run_es,
    run_poet,
    train_lm,
)
from fiber_tpu_torch.utils import flops

#: the module (the package's ``entry`` attribute is the function)
entry = importlib.import_module("fiber_tpu_torch.entry")
ROOT = pathlib.Path(__file__).resolve().parents[1]
TINY = ("--pop", "8", "--steps", "10", "--gens", "2", "--seq", "64",
        "--no-pool-bench")
MODES = {"es": (), "pixels": ("--pixels",), "biped": ("--biped",),
         "poet": ("--poet",), "attention": ("--attention",),
         "lm": ("--lm",)}
#: the keys of the legs that ``bench.py`` runs only on a TPU
LEG_KEYS = {
    "attention": {  # bench.py:3190-3293
        "flash_tokens_per_sec", "flash_speedup", "flash_max_err_vs_xla",
        "flash_mfu", "flash_window", "flash_window_tokens_per_sec",
        "flash_window_prefix_err", "flash_window_mfu",
        "ring_flash_tokens_per_sec", "ring_flash_speedup",
        "ring_flash_mfu"},
    "lm": {"flash_tokens_per_sec", "flash_train_speedup",  # :3387-3420
           "flash_final_loss", "flash_mfu"},
}
CONFIG_KEYS = ("metric", "unit", "pop_size", "episode_steps", "generations",
               "n_devices", "seq_len", "heads", "head_dim", "dim", "layers",
               "iterations", "rollout_steps", "causal", "dtype", "attention",
               "flash_window")
ENV = {"es": "cartpole", "pixels": "pixels", "biped": "biped"}
ICI_TINY = ("--ici", "--ici-mb", "0.25", "--ici-gens", "2",
            "--ici-tasks", "4")


def _lines(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def _jax_env():
    """The JAX package's environment for one CPU device: the tests'
    ``XLA_FLAGS`` without the 8 virtual devices."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", FIBER_BACKEND="local")
    env["XLA_FLAGS"] = " ".join(
        f for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f)
    env.pop("FIBER_BENCH_ENFORCE", None)
    return env


@functools.lru_cache(maxsize=None)
def _jax_bench(argv):
    """``bench.py --platform cpu argv`` in a fresh temporary directory:
    (its exit code, its JSON lines)."""
    import tempfile

    with tempfile.TemporaryDirectory() as cwd:
        proc = subprocess.run(
            [sys.executable, str(ROOT / "bench.py"), "--platform", "cpu",
             *argv], cwd=cwd, env=_jax_env(), capture_output=True,
            text=True, timeout=300)
        assert os.listdir(cwd) == []
    return proc.returncode, _lines(proc.stdout)


def _port(argv):
    """The port's ``main(argv + --device cpu)`` in this process: (its
    exit code, its JSON lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([*argv, "--device", "cpu"])
    return rc, _lines(buf.getvalue())


@functools.lru_cache(maxsize=None)
def _port_cached(argv):
    return _port(argv)


def _one(argv, cached=True):
    rc, lines = (_port_cached if cached else _port)(tuple(argv))
    assert rc == 0 and len(lines) == 1, (rc, lines)
    return lines[0]


# -- (a) the line's keys against bench.py's ----------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_keys_cover_bench_py(mode):
    """The port's line has every key of ``bench.py``'s at the same flags
    (its TPU-only legs' ``*_error`` keys aside) and the legs' own keys;
    the configuration keys are equal; no ``*_error`` key. ``bench.py``
    runs as a subprocess: 5-25 s."""
    argv = (*TINY, *MODES[mode])
    rc, jax_lines = _jax_bench(argv)
    assert rc == 0 and len(jax_lines) == 1, jax_lines
    want, got = jax_lines[0], _one(argv)
    keys = {k for k in want if not k.endswith("_error")}
    keys |= LEG_KEYS.get(mode, set())
    assert keys <= set(got), sorted(keys - set(got))
    assert not [k for k in got if k.endswith("_error")], got
    for key in CONFIG_KEYS:
        if key in want:
            assert got[key] == want[key], key
    assert got["platform"] == want["platform"] == "cpu"
    assert got["vs_baseline"] is None
    assert got["value"] > 0
    if mode == "lm":
        assert got["model_flops_per_step"] == pytest.approx(
            want["model_flops_per_step"], rel=1e-9)


# -- (b) the line's numbers against the port's entry functions ---------------

@pytest.mark.parametrize("mode", ["es", "pixels", "biped"])
def test_es_mean_fitness_is_run_es(mode):
    """``mean_fitness`` is ``run_es``'s last generation's mean at the same
    widths and seeds: the bench and ``run_es`` both run a warm-up
    ``run_fused`` of ``--gens`` and then a timed one."""
    got = _one((*TINY, *MODES[mode]))
    _, stats, _ = run_es(device="cpu", pop=8, max_steps=10, generations=2,
                         env=ENV[mode])
    assert got["mean_fitness"] == float(stats[-1][0])
    assert got["env_steps_per_sec"] == pytest.approx(
        got["value"] * 10, rel=1e-3)


def test_poet_history_is_run_poet():
    got = _one((*TINY, "--poet"))
    history, evals, _ = run_poet(device="cpu", pop=8, max_steps=10,
                                 iterations=2, es_steps=4, max_pairs=6)
    assert got["history"] == history
    assert got["final_pairs"] == history[-1]["pairs"]
    assert got["total_transfers"] == sum(h["transfers"] for h in history)
    assert got["fitness_last_iter"] == round(history[-1]["mean_fitness"], 2)


@pytest.mark.parametrize("leg", ["ring", "flash"])
def test_lm_losses_are_train_lm(leg):
    """``final_loss`` is ``train_lm(attention="ring")``'s last loss, and
    ``flash_final_loss`` ``train_lm(attention="flash")``'s."""
    got = _one((*TINY, "--lm"))
    losses, _ = train_lm(device="cpu", seq=64, steps=5, attention=leg)
    key = "final_loss" if leg == "ring" else "flash_final_loss"
    assert got[key] == float(losses[-1])


def test_attention_legs_agree_with_the_headline():
    got = _one((*TINY, "--attention"))
    for key in ("flash_max_err_vs_xla", "flash_window_prefix_err",
                "ring_flash_max_err_vs_xla"):
        assert 0 <= got[key] <= bench.LEG_TOL, (key, got[key])
    assert got["flash_window"] == bench.FLASH_WINDOW


@pytest.mark.parametrize("mode", ["es", "poet", "attention", "lm"])
def test_rate_fields_are_utils_flops(mode, monkeypatch):
    """With a peak override, ``mfu`` is ``model_flops_per_sec`` over it
    and the FLOPs behind each rate are ``utils/flops``'s count."""
    monkeypatch.setenv("FIBER_PEAK_FLOPS", "1e12")
    got = _one((*TINY, *MODES[mode]), cached=False)
    assert got["peak_row"] == "env:1e+12"
    fps = got.get("model_flops_per_sec") or got.get("attn_flops_per_sec")
    assert got["mfu"] == pytest.approx(fps / 1e12, rel=1e-3)
    if mode == "es":
        policy = flagship_policy()
        per_unit = flops.es_flops_per_gen(policy, "CartPole", 10, 8,
                                          policy.dim) / 8
    elif mode == "poet":
        poet = make_poet(device="cpu", pop=8, max_steps=10)
        per_unit = flops.rollout_flops_per_eval(poet.policy,
                                                "ParamCartPole", 10)
    elif mode == "attention":
        per_unit = flops.attention_flops(64, 8, 64, causal=True) / 64
    else:
        per_unit = got["model_flops_per_step"] / 64
    # ``value`` is rounded to 0.01 evals/s or 0.1 tokens/s
    assert fps / per_unit == pytest.approx(got["value"], abs=0.051,
                                           rel=1e-6)


# -- (c) failures ----------------------------------------------------------------

def test_cuda_without_a_card_prints_an_error_line():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main([*TINY])
    lines = _lines(buf.getvalue())
    assert rc != 0 and len(lines) == 1, (rc, lines)
    assert lines[0]["value"] == 0.0
    assert "CUDA is not available" in lines[0]["error"]


def _raise_when(pred, fn):
    def wrapped(*args, **kwargs):
        if pred(*args, **kwargs):
            raise RuntimeError("the leg was made to fail")
        return fn(*args, **kwargs)
    return wrapped


@pytest.mark.parametrize("leg", ["flash", "flash_window", "ring_flash",
                                 "lm_flash"])
def test_a_failing_leg_keeps_the_headline_and_exits_1(leg, monkeypatch):
    from fiber_tpu_torch.ops import flash_attention as fa
    from fiber_tpu_torch.ops import ring_attention as ra

    if leg == "flash":
        monkeypatch.setattr(fa, "flash_attention", _raise_when(
            lambda *a, window=None, **k: window is None, fa.flash_attention))
    elif leg == "flash_window":
        monkeypatch.setattr(fa, "flash_attention", _raise_when(
            lambda *a, window=None, **k: window is not None,
            fa.flash_attention))
    elif leg == "ring_flash":
        monkeypatch.setattr(ra, "ring_attention", _raise_when(
            lambda *a, local="xla", **k: local == "flash",
            ra.ring_attention))
    else:
        monkeypatch.setattr(entry, "train_lm", _raise_when(
            lambda *a, attention="flash", **k: attention == "flash",
            entry.train_lm))
    mode = "--lm" if leg == "lm_flash" else "--attention"
    rc, lines = _port((*TINY, mode))
    assert rc == 1 and len(lines) == 1
    line = lines[0]
    key = "flash_error" if leg == "lm_flash" else f"{leg}_error"
    assert "made to fail" in line[key]
    assert [k for k in line if k.endswith("_error")] == [key]
    assert line["value"] > 0 and "error" not in line


def test_a_mode_that_raises_prints_its_line(monkeypatch):
    def boom(*args, **kwargs):
        raise RuntimeError("no POET today")

    monkeypatch.setattr(entry, "run_poet", boom)
    rc, lines = _port((*TINY, "--poet"))
    assert rc == 1 and len(lines) == 1
    assert lines[0]["metric"] == "poet_policy_evals_per_sec"
    assert lines[0]["value"] == 0.0 and "no POET today" in lines[0]["error"]


def test_the_watchdog_prints_a_line_and_exits_2():
    """A run whose set-up outlasts ``--init-timeout`` (here 1 ms, shorter
    than importing torch) prints its failure line and exits 2."""
    proc = subprocess.run(
        [sys.executable, "-m", "fiber_tpu_torch.bench", "--device", "cpu",
         "--init-timeout", "0.001", *TINY], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    lines = _lines(proc.stdout)
    assert proc.returncode == 2 and len(lines) == 1, proc.stdout
    assert lines[0]["value"] == 0.0
    assert lines[0]["error"] == "device initialization timed out"


@pytest.mark.parametrize("enforce", ["", "1"])
def test_enforce_fails_the_1ms_point_over_budget(enforce, monkeypatch):
    monkeypatch.setenv("FIBER_BENCH_ENFORCE", enforce)
    monkeypatch.setattr(bench, "_pool_bench", lambda dev: {
        "pool_map_1ms_overhead_vs_mp": 1.5,
        "pool_map_1ms_budget": bench._POOL_1MS_BUDGET,
        "pool_map_1ms_over_budget": True})
    rc, lines = _port(("--pop", "8", "--steps", "10", "--gens", "1"))
    assert rc == (1 if enforce else 0)
    assert lines[0]["pool_map_1ms_over_budget"] is True


@pytest.mark.parametrize("argv", [
    ("--poet", "--lm"), ("--ici", "--pixels"), ("--gens", "0"),
    ("--pop", "1"), ("--steps", "0"), ("--attention", "--seq", "32"),
    ("--platform", "cpu"), ("--record",), ("--store",)],
    ids=lambda a: " ".join(a))
def test_bad_arguments_are_refused(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main(list(argv))
    assert exc.value.code == 2


def test_help_says_the_host_plane_modes_are_to_come(capsys):
    with pytest.raises(SystemExit):
        bench.main(["--help"])
    out = capsys.readouterr().out
    assert "still to come" in out and "--cluster" in out


def test_importing_the_module_imports_no_torch():
    """Pool workers import the task functions from this module: it must
    stay cheap to import."""
    code = ("import sys, fiber_tpu_torch.bench; "
            "print('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.stdout.strip() == "False", proc.stderr


# -- (d) the default mode's pool leg ---------------------------------------------

def test_default_mode_with_the_pool_leg(monkeypatch):
    """The default mode with its pool leg: 12 host pools (4 workers each,
    the port's and multiprocessing's) and the device-path map, about 15
    s here."""
    monkeypatch.delenv("FIBER_BENCH_ENFORCE", raising=False)
    before = os.environ.get("FIBER_BACKEND")
    rc, lines = _port(("--pop", "8", "--steps", "10", "--gens", "2"))
    assert rc == 0 and len(lines) == 1, lines
    line = lines[0]
    for tag in ("1ms", "10ms"):
        assert line[f"pool_map_{tag}_tasks_per_sec"] > 0
        assert line[f"pool_map_{tag}_overhead_vs_mp"] > 0
    assert line["pool_map_1ms_budget"] == 1.1
    assert line["pool_map_1ms_over_budget"] == (
        line["pool_map_1ms_overhead_vs_mp"] > 1.1)
    assert line["pool_map_device_cold_ms"] > 0
    assert line["pool_map_device_tasks_per_sec"] > 0
    assert not [k for k in line if k.endswith("_error")], line
    assert os.environ.get("FIBER_BACKEND") == before


# -- (e) --ici ---------------------------------------------------------------------

def test_ici_lines_match_bench_py():
    """The three lines of ``bench.py --ici`` and the port's at the same
    flags: the same metric names, the correctness fields held, and the
    exit code 1 exactly when ``ici_gates`` marks a gate missed."""
    _, want = _jax_bench(ICI_TINY)
    rc, got = _port(ICI_TINY)
    assert [x["metric"] for x in got] == [x["metric"] for x in want] == [
        "ici_repeat_wire_bytes", "ici_broadcast_wall_ratio", "ici_gates"]
    for mine, theirs in zip(got, want):
        assert set(theirs) <= set(mine), set(theirs) - set(mine)
    wire, ratio, gates = got
    assert wire["payload_shape_ok"] is True
    assert wire["payload_device"] == "cpu"
    assert wire["value"] <= bench._ICI_REPEAT_WIRE_MAX
    assert wire["device_tier_hits"] >= wire["generations"] - 1
    assert wire["ici_transfer_bytes"] == 65536 * 4
    assert ratio["value"] == gates["wall_ratio"] > 0
    missed = gates["over_budget"] or gates["under_floor"] or \
        gates["tier_cold"]
    assert rc == int(missed)


@pytest.mark.parametrize("flag", ["over_budget", "under_floor",
                                  "tier_cold", None])
def test_ici_rc_is_1_exactly_when_a_gate_is_missed(flag):
    gates = {"over_budget": False, "under_floor": False, "tier_cold": False,
             "repeat_wire_bytes": 0, "device_tier_hits": 1,
             "wall_ratio": 1.5}
    if flag:
        gates[flag] = True
    assert bench._ici_rc(gates) == (1 if flag else 0)
