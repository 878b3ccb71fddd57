"""The port's ES and POET FLOP counts against the JAX package's, and its
peaks and MFU keyed to the CUDA device name, on the CPU (a card's name
is monkeypatched in; no card is touched)."""

import pytest
import torch

from fiber_tpu.models import ConvPolicy as JaxConvPolicy
from fiber_tpu.models import GRUPolicy as JaxGRUPolicy
from fiber_tpu.models import MLPPolicy as JaxMLPPolicy
from fiber_tpu.utils import flops as jax_flops

from fiber_tpu_torch.entry import run_es, run_poet
from fiber_tpu_torch.models.policies import ConvPolicy, GRUPolicy, MLPPolicy
from fiber_tpu_torch.utils import flops

H100 = "NVIDIA H100 80GB HBM3"

POLICIES = {
    "mlp_flagship": lambda m: m(4, 2, hidden=(32, 32)),
    "mlp_poet": lambda m: m(4, 2, hidden=(16,)),
    "mlp_biped": lambda m: m(14, 4, hidden=(32, 32)),
    "gru": lambda m: m(4, 2, hidden=32),
    "conv_pixels": lambda m: m((24, 24, 1), 5),
    "conv_small": lambda m: m((8, 8, 1), 5, channels=(2,), hidden=4),
}
PORT = {"mlp": MLPPolicy, "gru": GRUPolicy, "conv": ConvPolicy}
JAX = {"mlp": JaxMLPPolicy, "gru": JaxGRUPolicy, "conv": JaxConvPolicy}


def _pair(name):
    kind = name.split("_")[0]
    make = POLICIES[name]
    return make(PORT[kind]), make(JAX[kind])


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_counts_match_jax(name):
    pol, jpol = _pair(name)
    assert pol.dim == jpol.dim
    assert (flops.policy_flops_per_action(pol)
            == jax_flops.policy_flops_per_action(jpol) > 0)


@pytest.mark.parametrize("env", sorted(jax_flops.ENV_STEP_FLOPS))
def test_rollout_and_es_counts_match_jax(env):
    """Every env of the table with every policy: one episode, and one ES
    generation at the flagship's pop and at a small one."""
    assert flops.ENV_STEP_FLOPS == jax_flops.ENV_STEP_FLOPS
    for name in POLICIES:
        pol, jpol = _pair(name)
        assert (flops.rollout_flops_per_eval(pol, env, 500)
                == jax_flops.rollout_flops_per_eval(jpol, env, 500))
        for pop in (4096, 64):
            assert (flops.es_flops_per_gen(pol, env, 500, pop, pol.dim)
                    == jax_flops.es_flops_per_gen(jpol, env, 500, pop,
                                                  jpol.dim))


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="no FLOP counter"):
        flops.policy_flops_per_action(object())


@pytest.fixture
def card(monkeypatch):
    """Names the CUDA device ``name[0]`` (an H100 unless changed), with
    no override and an empty miss record."""
    name = [H100]
    monkeypatch.setattr(flops.torch.cuda, "get_device_name",
                        lambda device=None: name[0])
    monkeypatch.delenv("FIBER_PEAK_FLOPS", raising=False)
    monkeypatch.setattr(flops, "_reported_miss", set())
    return name


def test_h100_resolves_to_the_bf16_dense_peak(card):
    cuda = torch.device("cuda", 0)
    assert flops.device_peak_flops(cuda) == flops.H100_PEAK_FLOPS[
        "bfloat16"] == 989e12
    assert flops.peak_report([cuda]) == {
        "device_kind": H100.lower(), "peak_row": "h100:9.89e+14"}
    assert flops.mfu(494.5e12, [cuda]) == 0.5


def test_unknown_card_is_null_and_reported_once(card, capsys):
    card[0] = "NVIDIA Mystery GPU"
    cuda = torch.device("cuda", 0)
    for _ in range(3):
        assert flops.device_peak_flops(cuda) is None
    assert flops.mfu(1e12, [cuda]) is None
    err = capsys.readouterr().err.strip().splitlines()
    assert len(err) == 1 and "FLOPS PEAK TABLE MISS" in err[0]
    assert "nvidia mystery gpu" in err[0]
    assert flops.peak_report([cuda])["peak_row"] is None


def test_cpu_has_no_peak(card, capsys):
    cpu = torch.device("cpu")
    assert flops.device_peak_flops(cpu) is None
    assert flops.mfu(1e12, [cpu]) is None
    assert flops.peak_report([cpu]) == {"device_kind": "cpu",
                                        "peak_row": None}
    assert capsys.readouterr().err == ""


def test_env_override(card, monkeypatch):
    """``FIBER_PEAK_FLOPS`` replaces the table, on any device."""
    monkeypatch.setenv("FIBER_PEAK_FLOPS", "2e12")
    card[0] = "NVIDIA Mystery GPU"
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        assert flops.device_peak_flops(dev) == 2e12
        assert flops.peak_report([dev])["peak_row"] == "env:2e+12"
        assert flops.mfu(1e12, [dev]) == 0.5


def test_ranks_on_one_card_share_its_peak(card):
    """A 4-rank mesh on one card divides by that card's peak once; the
    JAX package would sum one peak a device."""
    ranks = [torch.device("cuda", 0)] * 4
    assert flops.mfu(989e12, ranks) == 1.0
    assert flops.mfu(989e12, [torch.device("cuda", 0),
                              torch.device("cuda", 1)]) == 0.5


def test_run_es_and_run_poet_report_bench_fields():
    """On the CPU the rates are there and MFU is null; the counts are
    the JAX functions' (``es_flops_per_gen``, ``rollout_flops_per_eval``
    of the policy bench.py uses)."""
    _, _, es = run_es(device="cpu", pop=16, max_steps=10, generations=2)
    want = jax_flops.es_flops_per_gen(JaxMLPPolicy(4, 2, hidden=(32, 32)),
                                      "CartPole", 10, 16, 1282) * 2
    assert es["model_flops_per_sec"] == pytest.approx(
        want / es["seconds"], rel=1e-12)
    assert es["evals_per_sec"] == pytest.approx(32 / es["seconds"],
                                                rel=1e-12)
    history, evals, poet = run_poet(device="cpu", pop=16, max_steps=10,
                                    iterations=1, es_steps=1, max_pairs=2,
                                    ranks=2)
    per_eval = jax_flops.rollout_flops_per_eval(
        JaxMLPPolicy(4, 2, hidden=(16,)), "ParamCartPole", 10)
    assert poet["model_flops_per_sec"] == pytest.approx(
        evals * per_eval / poet["seconds"], rel=1e-12)
    for perf in (es, poet):
        assert perf["mfu"] is None and perf["device_kind"] == "cpu"
        assert perf["peak_row"] is None
