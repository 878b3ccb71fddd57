"""The port's user programs (``fiber_tpu_torch/examples``, and
``fiber_tpu_torch.entry``'s ``dryrun_multichip`` and ``weak_scaling``)
against the JAX package's, on the CPU.

* The long-context LM example: JAX's ``TinyLM(vocab 32, dim 32, 8 heads,
  2 layers, max_seq 64)`` on the flash plane (Pallas in interpret mode)
  and on the ring plane (over JAX's 8 virtual CPU devices), its weights
  carried into the example's model, 3 batched AdamW steps (JAX through
  ``optax.adamw(1e-3, weight_decay=0.01)``, the port through the
  example's optimizer) on the same numpy induction batch: losses,
  parameters after the steps and the example's half losses within 1e-5.
* Every program's ``main(argv)`` at the JAX smoke sizes with ``--device
  cpu``, its output lines matched; and without ``--device`` each raises,
  since this machine has no card.
* ``poet_cartpole``'s minimal-criterion defaults against the JAX
  program's own rule (its ``main`` run with a recording POET).
* ``dryrun_multichip`` on 2, 4 and 8 ranks, ``weak_scaling``'s record,
  and ``default_mesh``/``mesh_from_config`` against JAX's.
* The host-only tours are the JAX programs with the package renamed.

The pool and ring programs start worker or rank processes (each a fresh
interpreter, one to two seconds); ``pod_es_ring --sim 2`` also starts two
local host agents (about 20 s in all).
"""

import ast
import importlib.util
import json
import pathlib
import re
import subprocess
import sys
import types

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fiber_tpu import config as jax_config
from fiber_tpu.models import TinyLM as JaxTinyLM
from fiber_tpu.models.transformer import make_train_step as jax_train_step
from fiber_tpu.parallel import mesh as jax_mesh

from fiber_tpu_torch import config
from fiber_tpu_torch.entry import dryrun_multichip, weak_scaling
from fiber_tpu_torch.examples import (
    es_cartpole,
    es_conv_pixels,
    es_pool_gym,
    long_context_lm,
    map_elites_maze,
    novelty_maze,
    parzen_estimation,
    pi_estimation,
    pod_es_ring,
    poet_cartpole,
    tune_es,
)
from fiber_tpu_torch.models import convert
from fiber_tpu_torch.models.transformer import adamw, make_train_step
from fiber_tpu_torch.parallel import mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-5
LM = dict(vocab=32, dim=32, layers=2, seq=64)
LM_BATCH = 4
LM_STEPS = 3


def _jax_half_losses(model, params, tokens):
    """The JAX example's ``half_losses``."""
    half = tokens.shape[1] // 2

    def one(t):
        logits = model.apply(params, t)[:-1]
        logp = jax.nn.log_softmax(logits, axis=-1)
        nll = -jnp.take_along_axis(logp, t[1:][:, None], axis=1)
        return nll[: half - 1].mean(), nll[half - 1:].mean()

    l1, l2 = jax.vmap(one)(tokens)
    return float(l1.mean()), float(l2.mean())


def _max_leaf_err(torch_tree, jax_tree):
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), torch_tree,
        jax_tree)
    return max(jax.tree_util.tree_leaves(errs))


@pytest.mark.parametrize("attention", ["flash", "ring"])
def test_long_context_lm_steps_match_jax(attention):
    jm = JaxTinyLM(vocab=LM["vocab"], dim=LM["dim"], heads=8,
                   layers=LM["layers"], max_seq=LM["seq"],
                   attention=attention)
    jparams = jm.init(jax.random.PRNGKey(0))
    model = long_context_lm.build_model(LM["vocab"], LM["dim"], LM["layers"],
                                        LM["seq"], attention, device="cpu")
    model.load_state_dict(convert.tinylm_params_from_jax(
        jax.device_get(jparams), device="cpu"))
    half = np.random.default_rng(5).integers(
        0, LM["vocab"], (LM_BATCH, LM["seq"] // 2))
    tokens = np.concatenate([half, half], axis=1)

    opt = optax.adamw(1e-3, weight_decay=0.01)
    opt_state = opt.init(jparams)
    jstep = jax_train_step(jm, opt, batched=True)
    step = make_train_step(
        model, adamw(model.parameters(), 1e-3, long_context_lm.WEIGHT_DECAY),
        batched=True)
    for _ in range(LM_STEPS):
        jparams, opt_state, want = jstep(jparams, opt_state,
                                         jnp.asarray(tokens))
        got = step(torch.from_numpy(tokens))
        assert abs(float(got) - float(want)) < TOL
    assert _max_leaf_err(convert.tinylm_tree_from_torch(model),
                         jparams) < TOL
    got_halves = long_context_lm.half_losses(model, torch.from_numpy(tokens))
    want_halves = _jax_half_losses(jm, jparams, jnp.asarray(tokens))
    for g, w in zip(got_halves, want_halves):
        assert abs(float(g) - w) < TOL


def test_example_optimizer_is_optax_adamw():
    model = long_context_lm.build_model(16, 16, 1, 16, "flash",
                                        device="cpu")
    (group,) = adamw(model.parameters(), 3e-4,
                     long_context_lm.WEIGHT_DECAY).param_groups
    assert group["lr"] == 3e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 0.01
    assert len(group["params"]) == len(list(model.parameters()))


def test_induction_batches_repeat_their_first_half():
    gen = torch.Generator().manual_seed(1)
    tokens = long_context_lm.make_batch(gen, 3, 10, 7, "cpu")
    assert tokens.shape == (3, 10) and int(tokens.max()) < 7
    assert torch.equal(tokens[:, :5], tokens[:, 5:])


# -- every program's main at the JAX smoke sizes -----------------------------

#: (module, argv, lines the output must hold)
SMOKE = {
    "es_cartpole": (es_cartpole, ["--pop", "32", "--gens", "4", "--steps",
                                  "50"], ["gen    3", "env-steps/s"]),
    "es_cartpole_fused": (es_cartpole, ["--pop", "32", "--gens", "20",
                                        "--steps", "30", "--fused"],
                          ["gen   19", "env-steps/s"]),
    "es_cartpole_adam": (es_cartpole, ["--pop", "32", "--gens", "3",
                                       "--steps", "30", "--optimizer",
                                       "adam"], ["env-steps/s"]),
    "es_cartpole_pgpe": (es_cartpole, ["--algo", "pgpe", "--pop", "32",
                                       "--gens", "3", "--steps", "30"],
                         ["gen    2", "evals/s [pgpe]"]),
    "es_cartpole_cma_fused": (es_cartpole, ["--algo", "cma", "--pop", "32",
                                            "--gens", "3", "--steps", "30",
                                            "--fused"], ["[cma]"]),
    "es_cartpole_fullcma_fused": (es_cartpole, [
        "--algo", "fullcma", "--pop", "32", "--gens", "3", "--steps", "30",
        "--fused"], ["[fullcma]"]),
    "long_context_lm": (long_context_lm, [
        "--seq", "64", "--steps", "5", "--batch", "4", "--dim", "32"],
        ["ring attention, seq 64 over 1 devices", "half2",
         "long-context training done"]),
    "long_context_lm_flash": (long_context_lm, [
        "--seq", "64", "--steps", "2", "--batch", "2", "--dim", "32",
        "--attention", "flash"], ["single device, kernels",
                                  "long-context training done"]),
    "poet_cartpole": (poet_cartpole, ["--iters", "2", "--pop", "32",
                                      "--steps", "40"],
                      ["poet iter 1:", "co-evolved (env, agent) pairs",
                       "evals/s"]),
    "poet_cartpole_biped": (poet_cartpole, ["--iters", "1", "--pop", "16",
                                            "--steps", "30", "--env",
                                            "biped"],
                            ["poet iter 0:", "co-evolved"]),
    "tune_es": (tune_es, ["--pops", "16,32", "--steps", "20", "--gens", "2"],
                ["pop=    32", '"best_pop": ']),
    "es_conv_pixels": (es_conv_pixels, ["--pop", "16", "--gens", "2",
                                        "--steps", "5"],
                       ["conv policy params: 38,501", "conv-policy evals"]),
    "novelty_maze": (novelty_maze, ["--pop", "64", "--gens", "4"],
                     ["plain ES", "NSRA-ES", "novelty search done"]),
    "map_elites_maze": (map_elites_maze, ["--gens", "3", "--batch", "32",
                                          "--cells", "6"],
                        ["coverage", "best elite fitness",
                         "map-elites done"]),
    "es_pool_gym": (es_pool_gym, ["--workers", "2", "--pop", "16", "--gens",
                                  "2"], ["gen 1: mean", "final policy",
                                         "pool-evaluated ES done"]),
    "pi_estimation": (pi_estimation, ["--workers", "2", "--samples",
                                      "20000"], ["pi ~= 3.1"]),
    "pi_estimation_device_map": (pi_estimation, [
        "--workers", "2", "--samples", "50000", "--device-map"],
        ["pi ~= 3.1", "(400000 samples"]),
    "parzen_estimation": (parzen_estimation, ["--workers", "2", "--samples",
                                              "100", "--widths", "6"],
                          ["evaluated 6 window widths", "best h = "]),
    "parzen_estimation_device_map": (parzen_estimation, [
        "--workers", "2", "--samples", "100", "--widths", "6",
        "--device-map"], ["evaluated 6 window widths", "best h = "]),
}


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_program_main_on_the_cpu(name, capsys):
    module, argv, lines = SMOKE[name]
    assert module.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    for line in lines:
        assert line in out, (line, out)


@pytest.mark.parametrize("name", sorted(SMOKE))
def test_program_without_a_card_raises(name):
    """With no ``--device``, a program runs on the card: here, where
    there is none, it raises before it starts any work."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    module, argv, _ = SMOKE[name]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def test_parzen_device_map_equals_the_host_loop():
    data = parzen_estimation.make_data(60)
    h = np.float32(0.3)
    want = parzen_estimation.parzen_loglik((float(h), data))
    got = parzen_estimation.loglik_tensor(torch.from_numpy(data),
                                          torch.tensor(h))
    assert abs(float(got) - want) < 1e-5


def test_pi_hash_uniforms_are_uniform_and_seeded():
    a = pi_estimation.hash_uniform(torch.tensor(3, dtype=torch.int32),
                                   50000)
    b = pi_estimation.hash_uniform(torch.tensor(3, dtype=torch.int32),
                                   50000)
    c = pi_estimation.hash_uniform(torch.tensor(4, dtype=torch.int32),
                                   50000)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert float(a.min()) >= 0.0 and float(a.max()) < 1.0
    # each of 10 bins of each coordinate holds 10% of the draws to within
    # 5 standard deviations of a binomial count
    counts = torch.stack([torch.histc(a[:, i], 10, 0.0, 1.0)
                          for i in range(2)])
    sd = (50000 * 0.1 * 0.9) ** 0.5
    assert float((counts - 5000).abs().max()) < 5 * sd


def test_es_pool_gym_simulator_is_the_jax_programs():
    spec = importlib.util.spec_from_file_location(
        "jax_es_pool_gym", ROOT / "examples" / "es_pool_gym.py")
    theirs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(theirs)
    for theta in np.random.default_rng(0).standard_normal((8, 4)):
        assert es_pool_gym.simulate_cartpole(list(theta)) == \
            theirs.simulate_cartpole(list(theta))


# -- poet_cartpole's minimal criterion ---------------------------------------

def _jax_poet_kwargs(argv, monkeypatch):
    """The keyword arguments that the JAX ``poet_cartpole.py`` hands its
    POET for ``argv``: its ``main`` runs against a POET that records
    them and stops."""
    from fiber_tpu.ops import poet as jax_poet

    seen = {}

    class Stop(Exception):
        pass

    def recording(*args, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(jax_poet, "POET", recording)
    spec = importlib.util.spec_from_file_location(
        "jax_poet_cartpole", ROOT / "examples" / "poet_cartpole.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    monkeypatch.setattr(sys, "argv", ["poet_cartpole.py", *argv])
    with pytest.raises(Stop):
        module.main()
    return seen


@pytest.mark.parametrize("env", ["cartpole", "hill", "biped"])
@pytest.mark.parametrize("steps", ["200", "77"])
def test_poet_minimal_criterion_defaults_are_the_jax_rule(env, steps,
                                                          monkeypatch):
    argv = ["--env", env, "--steps", steps]
    want = _jax_poet_kwargs(argv, monkeypatch)
    args = poet_cartpole.parse_args(argv)
    assert (args.mc_low, args.mc_high) == (want["mc_low"], want["mc_high"])
    poet = poet_cartpole.make_poet(args.env, 16, 2, args.steps, args.mc_low,
                                   args.mc_high, "cpu")
    want_high = (want["mc_high"] if want["mc_high"] is not None
                 else 0.9 * int(steps))
    assert (poet.mc_low, poet.mc_high) == (want["mc_low"], want_high)


def test_poet_explicit_minimal_criterion_is_kept():
    args = poet_cartpole.parse_args(["--env", "hill", "--mc-low", "2",
                                     "--mc-high", "9"])
    assert (args.mc_low, args.mc_high) == (2.0, 9.0)


# -- entry: the dry run and the scaling record -------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip(n):
    dryrun_multichip(n, device="cpu")  # raises on a failed check


@pytest.mark.parametrize("call", [
    lambda: dryrun_multichip(2),
    lambda: weak_scaling(mesh_sizes=(1,), gens=1, per_device_pop=8,
                         steps=5)], ids=["dryrun_multichip", "weak_scaling"])
def test_entry_functions_without_a_card_raise(call):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()


def test_entry_module_runs_the_dry_run():
    proc = subprocess.run(
        [sys.executable, "-m", "fiber_tpu_torch.entry", "4", "--device",
         "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "dryrun_multichip ok" in proc.stdout


def test_weak_scaling_record_structure(tmp_path):
    """The JAX package's ``test_weak_scaling_record_structure`` on the
    port's record."""
    rec = weak_scaling(mesh_sizes=(1, 2), gens=2, per_device_pop=8,
                       steps=10, device="cpu")
    weak, strong = rec["weak"], rec["strong"]
    assert weak["curve"] and strong["curve"], rec
    assert [c["n_devices"] for c in weak["curve"]] == [1, 2]
    for c in weak["curve"]:
        assert c["pop_size"] == 8 * c["n_devices"]
        assert c["steps_per_sec"] > 0
        assert c["evals_per_sec_per_device"] > 0
    assert len(weak["efficiency_vs_1dev"]) == 2
    assert weak["efficiency_vs_1dev"][0] == 1.0
    assert {c["pop_size"] for c in strong["curve"]} == {16}
    assert [c["n_devices"] for c in strong["curve"]] == [1, 2]
    assert strong["overhead_vs_1dev"][0] == 1.0
    for c in strong["curve"]:
        assert c["wall_sec"] > 0
    assert "by construction" in weak["note"]
    assert "overhead" in strong["note"]
    assert rec["platform"] == "cpu"
    json.dumps(rec)


@pytest.mark.parametrize("spec", ["", "4", "4x2"])
def test_default_mesh_matches_jax(spec, monkeypatch):
    monkeypatch.setattr(jax_config, "get",
                        lambda: types.SimpleNamespace(mesh_shape=spec))
    monkeypatch.setattr(config, "get",
                        lambda: types.SimpleNamespace(mesh_shape=spec))
    jax_mesh.reset_default_mesh()
    mesh.reset_default_mesh()
    try:
        assert mesh.mesh_from_config() == jax_mesh.mesh_from_config()
        want = jax_mesh.default_mesh()
        got = mesh.default_mesh("cpu")
        assert mesh.default_mesh("cpu") is got
        assert got.names == tuple(want.axis_names)
        # with no setting the JAX default spans the 8 devices; the port's
        # ranks are not devices, and its default is one rank
        assert got.shape == (tuple(want.devices.shape) if spec else (1,))
        assert all(d.type == "cpu" for d in got.devices)
    finally:
        jax_mesh.reset_default_mesh()
        mesh.reset_default_mesh()


def test_pod_es_ring_sim_cluster(capsys):
    """The ranks start as jobs of two local host agents and join one
    gloo group; the ES leaves every rank with the same params. The
    agents, the manager and the two ranks are each a fresh process."""
    assert pod_es_ring.main(["--sim", "2", "--size", "2", "--device",
                             "cpu"]) == 0
    out = capsys.readouterr().out
    assert "all ranks joined cleanly" in out
    assert "params spread over the ranks: 0.0" in out


# -- the host-only tours ------------------------------------------------------

TOURS = ["basics", "shared_data", "async_manager", "line_count",
         "bench_queue", "bench_frameworks", "es_pool_simple"]
#: the JAX programs' preamble that puts the repo root on ``sys.path``;
#: the port's run as modules of the package and need none
PREAMBLE = ("import os as _os\nimport sys as _sys\n\n_sys.path.insert(\n"
            "    0, _os.path.dirname(_os.path.dirname(_os.path.abspath("
            "__file__))))\n")


def _normal(source: str) -> str:
    tree = ast.parse(source)
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and isinstance(
                    node.body[0].value, ast.Constant) and isinstance(
                        node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


@pytest.mark.parametrize("name", TOURS)
def test_tour_is_the_jax_program_renamed(name):
    theirs = (ROOT / "examples" / f"{name}.py").read_text()
    assert theirs.count(PREAMBLE) == 1
    theirs = re.sub(r"\bfiber_tpu\b", "fiber_tpu_torch",
                    theirs.replace(PREAMBLE, ""))
    ours = (ROOT / "fiber_tpu_torch" / "examples" / f"{name}.py").read_text()
    assert _normal(ours) == _normal(theirs)


#: (tour, argv, a line its output holds), at the JAX tests' sizes
TOUR_RUNS = {
    "basics": ([], "doubled remotely -> 42"),
    "shared_data": ([], "shared data semantics demonstrated"),
    "line_count": ([], "files counted"),
    "es_pool_simple": (["--workers", "2", "--iters", "120"], "|error|"),
    "async_manager": (["--envs", "2", "--steps", "2"], "speedup"),
    "bench_queue": (["--msgs", "100"], "round-trips of 1024B"),
}


@pytest.mark.parametrize("name", sorted(TOUR_RUNS))
def test_tour_runs(name, capsys, monkeypatch):
    argv, line = TOUR_RUNS[name]
    module = importlib.import_module(f"fiber_tpu_torch.examples.{name}")
    monkeypatch.setattr(sys, "argv", [name, *argv])
    assert module.main() in (0, None)
    assert line in capsys.readouterr().out
