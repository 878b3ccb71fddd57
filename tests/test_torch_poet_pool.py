"""The Pool-driven POET (``fiber_tpu_torch.examples.poet_distributed``)
on the CPU.

* ``es_worker`` against the JAX package's ``examples/poet_distributed.py``
  ``es_worker`` on the same payload. Random draws differ between the two
  (threefry vs Philox), so the JAX worker runs first with every ES
  step's noise and initial states recorded where they are derived from
  its key, as ``tests/test_torch_poet.py`` records POET's, on a
  one-device mesh (the port's worker holds one rank); the port's worker
  then takes those draws. Theta within 1e-5 (f32 updates summed in
  another order), the fitness (a mean of integer returns) exactly.
* The master loop through ``Pool(2)`` equals the same loop run in this
  process, exactly: the workers run the same ``es_worker`` on the same
  payloads. It starts two workers that import torch (a few seconds).
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import fiber_tpu.parallel.mesh as jax_mesh
from fiber_tpu.models import ParamCartPole as JaxParamCartPole
from fiber_tpu.ops import EvolutionStrategy as JaxES

from fiber_tpu_torch.examples import poet_distributed

ROOT = pathlib.Path(__file__).resolve().parents[1]
HIDDEN, POP, STEPS, ES_STEPS = (16,), 16, 20, 3


def _jax_example():
    spec = importlib.util.spec_from_file_location(
        "jax_poet_distributed", ROOT / "examples" / "poet_distributed.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _np(x):
    return np.asarray(jax.device_get(x))


@pytest.mark.parametrize("env_params", [
    JaxParamCartPole.DEFAULT, (12.0, 0.9, 7.0, 0.3)], ids=["default", "hard"])
def test_es_worker_matches_the_jax_examples(monkeypatch, env_params):
    one_device = Mesh(np.asarray(jax.devices()[:1]), ("pool",))
    monkeypatch.setattr(jax_mesh, "default_mesh", lambda: one_device)
    draws = []
    jax_step = JaxES.step

    def rec_step(self, params, key):
        eps_key, eval_key = jax.random.split(jax.random.fold_in(key, 0))
        draws.append((
            _np(jax.random.normal(eps_key, (self.pairs_per_dev, self.dim))),
            _np(jax.vmap(JaxParamCartPole.reset)(jax.random.split(
                eval_key, 2 * self.pairs_per_dev)))))
        return jax_step(self, params, key)

    monkeypatch.setattr(JaxES, "step", rec_step)
    dim = 4 * HIDDEN[0] + HIDDEN[0] + HIDDEN[0] * 2 + 2
    theta = (np.random.default_rng(1).standard_normal(dim) * 0.3).astype(
        np.float32)
    env = np.asarray(env_params, np.float32)
    want_theta, want_fit = _jax_example().es_worker(
        (theta, env, 7, (HIDDEN, POP, STEPS, ES_STEPS, 0.1, 0.03)))
    assert len(draws) == ES_STEPS

    monkeypatch.setattr(poet_distributed, "_WORKER_ES", {})
    conf = poet_distributed.make_conf(HIDDEN, POP, STEPS, ES_STEPS, 0.1,
                                      0.03, "cpu")
    es, _ = poet_distributed.worker_es(conf)
    queue, pending = list(draws), []

    def noise():
        eps, states = queue.pop(0)
        pending.append(torch.from_numpy(np.array(states)))
        return torch.from_numpy(np.array(eps))

    monkeypatch.setattr(es, "_noise", noise)
    monkeypatch.setattr(es, "reset_fn", lambda n, g: pending.pop())
    got_theta, got_fit = poet_distributed.es_worker((theta, env, 7, conf))
    assert queue == [] and pending == []
    assert got_theta.dtype == np.float32 and got_theta.shape == (dim,)
    assert np.abs(got_theta - _np(want_theta)).max() < 1e-5
    assert got_fit == want_fit
    assert not np.array_equal(got_theta, theta)


def test_pool_loop_equals_the_in_process_loop():
    """3 pairs at most, pop 16, 20-step episodes, 3 ES steps a pair, 2
    iterations: the history and the final pairs are equal. About 6 s:
    the pool's two workers start and import torch."""
    kw = dict(iterations=2, workers=2, pop=POP, pairs=3, steps=STEPS,
              es_steps=ES_STEPS, device="cpu")
    pooled = poet_distributed.run(**kw)
    local = poet_distributed.run(in_process=True, **kw)
    assert pooled[0] == local[0]
    assert [h["pairs"] for h in pooled[0]] == [1, 3]
    assert pooled[1] == local[1] > 0
    for a, b in zip(pooled[3].agents + pooled[3].envs,
                    local[3].agents + local[3].envs):
        assert torch.equal(a, b)
