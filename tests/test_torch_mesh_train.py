"""The port's TinyLM training through the sequence-parallel planes (ring,
Ulysses and multi-rank flash, over an 8-rank CPU mesh) against
``jax.value_and_grad`` of the JAX TinyLM over the 8-device CPU mesh and
its train step with ``optax.adamw``, on one set of weights (drawn with
numpy, loaded into both). The JAX flash plane runs its Pallas kernels
(forward and backward) in interpret mode; the port runs the kernels'
plain versions.

Tolerances are ``test_torch_train.py``'s: loss within 1e-5 and every
gradient leaf within 1e-6 abs (f32 forwards and backwards whose sums run
in other orders; gradients are O(0.1) at these weights); after 3 AdamW
steps, losses within 1e-5 and parameters within 1e-4 abs (Adam divides
each gradient by its own root mean square, so a gradient near zero can
move its parameter by up to lr on a rounding difference).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fiber_tpu.models.transformer import TinyLM as JaxTinyLM
from fiber_tpu.models.transformer import make_train_step as jax_train_step

from fiber_tpu_torch.models import convert
from fiber_tpu_torch.models.transformer import (
    TinyLM,
    adamw,
    make_train_step,
)
from fiber_tpu_torch.ops import dma_ring
from fiber_tpu_torch.ops import flash_attention as fa
from fiber_tpu_torch.ops import ring_attention as ring
from fiber_tpu_torch.parallel.mesh import make_mesh
from tests.test_torch_mesh_lm import CASES, N, SMALL

LOSS_TOL = 1e-5
GRAD_TOL = 1e-6
PARAM_TOL = 1e-4


def _pair(attention, pos, kv_heads):
    tree = convert.random_tinylm_tree(**SMALL, kv_heads=kv_heads, pos=pos,
                                      seed=0)
    cfg = dict(SMALL, attention=attention, pos=pos, kv_heads=kv_heads)
    jm = JaxTinyLM(**cfg, mesh=JaxMesh(np.asarray(jax.devices()[:N]),
                                       ("pool",)))
    model = TinyLM(**cfg, mesh=make_mesh("cpu", n=N))
    model.load_state_dict(convert.tinylm_params_from_jax(tree,
                                                         device="cpu"))
    return jm, jax.tree_util.tree_map(jnp.asarray, tree), model


def _tokens(seed=1):
    return np.random.default_rng(seed).integers(0, SMALL["vocab"],
                                                SMALL["max_seq"])


def _max_leaf_err(torch_tree, jax_tree):
    errs = jax.tree_util.tree_map(
        lambda a, b: float(np.abs(a - np.asarray(b)).max()), torch_tree,
        jax_tree)
    return max(jax.tree_util.tree_leaves(errs))


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_loss_and_grads_match_jax(case):
    jm, jparams, model = _pair(*CASES[case])
    tokens = _tokens()
    want_loss, want_grads = jax.value_and_grad(jm.loss)(
        jparams, jnp.asarray(tokens))
    loss = model.loss(torch.from_numpy(tokens))
    loss.backward()
    assert abs(loss.item() - float(want_loss)) < LOSS_TOL
    grads = convert.tinylm_tree_from_torch(
        {n: p.grad for n, p in model.named_parameters()})
    assert jax.tree_util.tree_structure(grads) == \
        jax.tree_util.tree_structure(want_grads)
    assert _max_leaf_err(grads, want_grads) < GRAD_TOL


@pytest.mark.parametrize("case", ["ring_learned", "flash_rope_gqa"])
def test_mesh_adamw_steps_match_jax(case):
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


def test_flash_plane_training_launch_plan(monkeypatch):
    """A training step of the multi-rank flash plane: every layer runs
    the forward on each rank's diagonal and past blocks, n + n(n-1)/2,
    and each of those blocks runs dq and dk/dv once in backward, with
    the lse cotangent of the merge; future blocks run nothing and
    rotations take the plain copies, never ``ring_exchange``. These are
    the wrappers the card counts as launches (40 / 40 / 40 / 0 a step at
    4 ranks and 4 layers). Gradients stay finite through the skipped
    blocks' lse of -1e30."""
    calls = {"fwd": 0, "dq": 0, "dkv": 0, "exchange": 0, "dlse": 0}

    def counted(key, fn):
        def call(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return call

    delta = fa.flash_bwd_delta

    def counted_delta(out, dout, dlse=None):
        calls["dlse"] += dlse is not None and bool((dlse != 0).any())
        return delta(out, dout, dlse)

    monkeypatch.setattr(fa, "flash_fwd", counted("fwd", fa.flash_fwd))
    monkeypatch.setattr(fa, "flash_bwd_dq", counted("dq", fa.flash_bwd_dq))
    monkeypatch.setattr(fa, "flash_bwd_dkv",
                        counted("dkv", fa.flash_bwd_dkv))
    monkeypatch.setattr(fa, "flash_bwd_delta", counted_delta)
    monkeypatch.setattr(dma_ring, "ring_exchange",
                        counted("exchange", dma_ring.ring_exchange))
    monkeypatch.setattr(ring, "ring_exchange",
                        counted("exchange", ring.ring_exchange))
    _, _, model = _pair("flash", "learned", None)
    model.loss(torch.from_numpy(_tokens())).backward()
    blocks = SMALL["layers"] * (N + N * (N - 1) // 2)
    assert calls["fwd"] == calls["dq"] == calls["dkv"] == blocks
    assert calls["exchange"] == 0
    # every block's lse feeds a merge, and its cotangent is nonzero but
    # on rank 0's diagonal block, which merges only with skipped blocks
    # and so keeps the weight 1 whatever its lse
    assert calls["dlse"] == blocks - SMALL["layers"]
    assert all(bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


@pytest.mark.parametrize("causal", [False, True])
def test_ring_recompute_gives_the_same_gradients(causal):
    """The ring plane's engine recomputes each chunk's score slabs in
    backward: its gradients equal, bit for bit, those of the engine that
    keeps the slabs, over two KV chunks and a ragged tail."""
    rng = np.random.default_rng(2)
    sq, skv, h, d = 48, 2 * ring._KV_CHUNK + 70, 2, 8
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               for shape in ((sq, h, d), (skv, h, d), (skv, h, d)))
    dout = torch.from_numpy(rng.standard_normal((sq, h, d), np.float32))
    q_pos = torch.arange(skv - sq, skv)
    grads = []
    for recompute in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        m, l, o = ring._accumulate_block(
            leaves[0], q_pos, leaves[1], leaves[2], 0,
            *ring._acc_init(leaves[0]), causal, recompute=recompute)
        out = ring._acc_finalize(o, l, q.dtype)
        out.backward(dout)
        grads.append([out.detach()] + [x.grad for x in leaves])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_train_lm_over_the_ring_on_cpu():
    """``train_lm`` on the ring plane over 8 ranks at a short sequence:
    losses finite and falling on the one batch, no kernel launched."""
    from fiber_tpu_torch import train_lm

    before = (fa.flash_fwd.launches, dma_ring.ring_exchange.launches)
    losses, secs = train_lm(device="cpu", seq=64, steps=3,
                            attention="ring", ranks=8)
    assert losses.shape == (3,) and bool(torch.isfinite(losses).all())
    assert float(losses[-1]) < float(losses[0]) and secs > 0
    assert (fa.flash_fwd.launches,
            dma_ring.ring_exchange.launches) == before
