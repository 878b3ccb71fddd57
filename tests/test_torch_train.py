"""The port's TinyLM training against the JAX package's, on one set of
weights (drawn with numpy, loaded into both). The JAX flash plane runs
its Pallas kernels (forward and backward) in interpret mode off-TPU; the
port runs the kernels' plain versions on the CPU.

Tolerances: loss within 1e-5 and every gradient leaf within 1e-6 abs (f32
forwards and backwards whose sums run in different orders; gradients are
O(0.1) at these weights); after 3 AdamW steps, losses within 1e-5 and
parameters within 1e-4 abs (Adam divides each gradient by its own root
mean square, so a gradient near zero can move its parameter by up to lr
on a rounding difference).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from fiber_tpu.models.transformer import make_train_step as jax_train_step

from fiber_tpu_torch.models import convert
from fiber_tpu_torch.models.transformer import adamw, make_train_step
from fiber_tpu_torch.ops import flash_attention as fa
from tests.test_torch_transformer import CASES, SMALL, _pair

LOSS_TOL = 1e-5
GRAD_TOL = 1e-6
PARAM_TOL = 1e-4


def _tokens(seed=1, batch=None):
    shape = (SMALL["max_seq"],) if batch is None else (batch,
                                                       SMALL["max_seq"])
    return np.random.default_rng(seed).integers(0, SMALL["vocab"], shape)


def _max_leaf_err(torch_tree, jax_tree):
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), torch_tree,
        jax_tree)
    return max(jax.tree_util.tree_leaves(errs))


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_match_jax(case):
    jm, jparams, model = _pair(*CASES[case])
    tokens = _tokens()
    want_loss, want_grads = jax.value_and_grad(jm.loss)(
        jparams, jnp.asarray(tokens))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    loss = model.loss(torch.from_numpy(tokens))
    loss.backward()
    assert before == (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
                      fa.flash_bwd_dkv.launches)   # the CPU runs no kernel
    assert abs(loss.item() - float(want_loss)) < LOSS_TOL
    grads = convert.tinylm_tree_from_torch(
        {n: p.grad for n, p in model.named_parameters()})
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(want_grads)
    assert _max_leaf_err(grads, want_grads) < GRAD_TOL


@pytest.mark.parametrize("case", list(CASES))
def test_adamw_steps_match_jax(case):
    jm, jparams, model = _pair(*CASES[case])
    tokens = _tokens()
    opt = optax.adamw(1e-3)
    opt_state = opt.init(jparams)
    jstep = jax_train_step(jm, opt)
    step = make_train_step(model, adamw(model.parameters(), 1e-3))
    for _ in range(3):
        jparams, opt_state, want = jstep(jparams, opt_state,
                                         jnp.asarray(tokens))
        got = step(torch.from_numpy(tokens))
        assert abs(float(got) - float(want)) < LOSS_TOL
    assert _max_leaf_err(convert.tinylm_tree_from_torch(model),
                         jparams) < PARAM_TOL


def test_batched_step_matches_jax():
    jm, jparams, model = _pair("flash", "rope", 2, None)
    tokens = _tokens(seed=3, batch=2)
    opt = optax.adamw(1e-3)
    opt_state = opt.init(jparams)
    jstep = jax_train_step(jm, opt, batched=True)
    step = make_train_step(model, adamw(model.parameters(), 1e-3),
                           batched=True)
    for _ in range(2):
        jparams, opt_state, want = jstep(jparams, opt_state,
                                         jnp.asarray(tokens))
        got = step(torch.from_numpy(tokens))
        assert abs(float(got) - float(want)) < LOSS_TOL
    assert _max_leaf_err(convert.tinylm_tree_from_torch(model),
                         jparams) < PARAM_TOL


def test_apply_builds_no_graph_under_no_grad():
    _, _, model = _pair("flash", "rope", 2, 9)
    tokens = torch.from_numpy(_tokens())
    with_graph = model.apply(tokens)
    assert with_graph.requires_grad
    with torch.no_grad():
        plain = model.apply(tokens)
    assert not plain.requires_grad and plain.grad_fn is None
    assert torch.equal(plain, with_graph.detach())


def test_adamw_pins_optax_defaults():
    _, _, model = _pair("flash", "learned", None, None)
    opt = adamw(model.parameters(), 3e-4)
    (group,) = opt.param_groups
    assert group["lr"] == 3e-4 and group["betas"] == (0.9, 0.999)
    assert group["eps"] == 1e-8 and group["weight_decay"] == 1e-4
    assert len(group["params"]) == len(list(model.parameters()))


@pytest.mark.parametrize("pos, kv_heads", [("learned", None), ("rope", 2)])
def test_tree_round_trip(pos, kv_heads):
    tree = convert.random_tinylm_tree(**SMALL, kv_heads=kv_heads, pos=pos,
                                      seed=4)
    _, _, model = _pair("flash", pos, kv_heads, None)
    model.load_state_dict(convert.tinylm_params_from_jax(tree,
                                                         device="cpu"))
    back = convert.tinylm_tree_from_torch(model)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    assert _max_leaf_err(back, tree) == 0.0


def test_train_lm_on_cpu():
    """The full-width entry point at a short sequence: losses finite and
    falling on the one batch, and no kernel launched on the CPU."""
    from fiber_tpu_torch import train_lm

    before = fa.flash_bwd_dkv.launches
    losses, secs = train_lm(device="cpu", seq=64, steps=3)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert float(losses[-1]) < float(losses[0]) and secs > 0
    assert fa.flash_bwd_dkv.launches == before


def test_train_lm_refuses_cpu_fallback(monkeypatch):
    from fiber_tpu_torch import train_lm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm(seq=64, steps=1)
