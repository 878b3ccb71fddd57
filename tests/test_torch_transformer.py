"""The port's TinyLM against the JAX TinyLM on one set of weights (drawn
with numpy, loaded into both). The JAX flash plane runs its Pallas
kernels in interpret mode off-TPU; the port runs the kernel's plain
version on the CPU.

Tolerance: logits and loss within 1e-5 in f32 (two f32 forwards whose
sums run in different orders; logits are O(0.1) at these weights).
Greedy decoding must match token for token.
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fiber_tpu.models.transformer import TinyLM as JaxTinyLM

from fiber_tpu_torch.models import convert
from fiber_tpu_torch.models.transformer import TinyLM

SMALL = dict(vocab=32, dim=32, heads=4, layers=2, max_seq=64)
TOL = 1e-5

# (attention, pos, kv_heads, window[, widths that replace SMALL's])
CASES = {
    "learned_mha": ("flash", "learned", None, None),
    "learned_gqa": ("flash", "learned", 2, None),
    "rope_mha": ("flash", "rope", None, None),
    "rope_gqa": ("flash", "rope", 2, None),
    "rope_gqa_window": ("flash", "rope", 2, 9),
    "reference_rope_gqa": ("reference", "rope", 2, None),
    # Gemma-2B's attention shape (head_dim 256, one KV head) at a small
    # width: the flash kernels' 256 instance on the card
    "rope_d256_kv1": ("flash", "rope", 1, None, dict(dim=512, heads=2)),
    # DeepSeek-V4-Flash's sliding-window attention (head_dim 512, one KV
    # head, a window) at a small width: the flash kernels' wide route on
    # the card
    "rope_d512_kv1_window": ("flash", "rope", 1, 16,
                             dict(dim=1024, heads=2)),
}


def _pair(attention, pos, kv_heads, window, widths=None, seed=0):
    small = dict(SMALL, **(widths or {}))
    cfg = dict(small, attention=attention, pos=pos, kv_heads=kv_heads,
               window=window)
    tree = convert.random_tinylm_tree(**small, kv_heads=kv_heads, pos=pos,
                                      seed=seed)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = TinyLM(**cfg, device="cpu")
    model.load_state_dict(convert.tinylm_params_from_jax(tree,
                                                         device="cpu"))
    return JaxTinyLM(**cfg), jparams, model


@pytest.mark.parametrize("case", list(CASES))
def test_tinylm_matches_jax(case):
    jm, jparams, model = _pair(*CASES[case])
    tokens = np.random.default_rng(1).integers(0, SMALL["vocab"],
                                               SMALL["max_seq"])
    want = np.asarray(jax.device_get(jm.apply(jparams, jnp.asarray(tokens))))
    got = model.apply(torch.from_numpy(tokens)).detach().numpy()
    assert got.shape == (SMALL["max_seq"], SMALL["vocab"])
    assert np.abs(got - want).max() < TOL
    want_loss = float(jm.loss(jparams, jnp.asarray(tokens)))
    assert abs(model.loss(torch.from_numpy(tokens)).item() - want_loss) \
        < TOL

    prompt = tokens[:5]
    want_gen = np.asarray(jm.generate(jparams, jnp.asarray(prompt), 20))
    got_gen = model.generate(torch.from_numpy(prompt), 20).numpy()
    assert got_gen.tolist() == want_gen.tolist()


def test_default_plane_is_the_reference_default():
    """``attention`` defaults to ``"ring"`` on both sides. A bare port
    TinyLM (the ring plane on its one-rank default mesh) matches a bare
    JAX TinyLM (the ring plane over the suite's 8-device CPU mesh) on
    the same weights."""
    def default(cls):
        return inspect.signature(cls.__init__).parameters["attention"].default

    assert default(TinyLM) == default(JaxTinyLM) == "ring"
    tree = convert.random_tinylm_tree(**SMALL, seed=0)
    model = TinyLM(**SMALL, device="cpu")
    model.load_state_dict(convert.tinylm_params_from_jax(tree,
                                                         device="cpu"))
    assert model.attention == "ring" and model.mesh.n_dev == 1
    jm = JaxTinyLM(**SMALL)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tokens = np.random.default_rng(3).integers(0, SMALL["vocab"],
                                               SMALL["max_seq"])
    want = np.asarray(jax.device_get(jm.apply(jparams, jnp.asarray(tokens))))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(tokens)).numpy()
        loss = model.loss(torch.from_numpy(tokens)).item()
    assert np.abs(got - want).max() < TOL
    assert abs(loss - float(jm.loss(jparams, jnp.asarray(tokens)))) < TOL


def test_decode_step_matches_full_apply():
    """Incremental decoding with the KV cache reproduces the full
    forward's logits row by row (the JAX package's own invariant)."""
    _, _, model = _pair("flash", "rope", 2, 9)
    tokens = torch.from_numpy(
        np.random.default_rng(2).integers(0, SMALL["vocab"],
                                          SMALL["max_seq"]))
    full = model.apply(tokens)
    caches = model.new_caches()
    for pos in range(SMALL["max_seq"]):
        step = model._decode_step(caches, pos, tokens[pos])
        assert torch.allclose(step, full[pos], atol=TOL, rtol=0)


def test_sampling_uses_the_generator():
    _, _, model = _pair("flash", "learned", None, None)
    prompt = torch.tensor([1, 2, 3])
    a = model.generate(prompt, 10, torch.Generator().manual_seed(5), 1.0)
    b = model.generate(prompt, 10, torch.Generator().manual_seed(5), 1.0)
    assert a.tolist() == b.tolist() and a.shape == (13,)
    with pytest.raises(ValueError):
        model.generate(prompt, 10, temperature=1.0)


def test_state_dict_uses_jax_names():
    _, _, model = _pair("flash", "learned", 2, None)
    keys = set(model.state_dict())
    assert {"embed", "pos", "out", "final_norm", "blocks.0.wq",
            "blocks.1.wkv", "blocks.1.b2"} <= keys
    assert "blocks.0.wqkv" not in keys


def _two_card_mesh():
    from fiber_tpu_torch.parallel.mesh import Mesh

    return Mesh((torch.device("cuda", 0), torch.device("cuda", 1)))


@pytest.mark.parametrize("kwargs, err", [
    # the mesh planes over ranks on several GPUs are not ported yet
    (dict(attention="ring", mesh=_two_card_mesh), NotImplementedError),
    (dict(attention="ulysses", mesh=_two_card_mesh), NotImplementedError),
    (dict(attention="reference", window=4), ValueError),
    (dict(kv_heads=3), ValueError),
    (dict(pos="rope", dim=20, heads=4), ValueError),
])
def test_tinylm_refuses_unported_or_bad_configs(kwargs, err):
    with pytest.raises(err):
        kwargs = {k: v() if callable(v) else v for k, v in kwargs.items()}
        TinyLM(**{**SMALL, **kwargs}, device="cpu")


def test_entry_points_refuse_cpu_fallback(monkeypatch):
    """No GPU and no explicit CPU request: the entry points raise."""
    from fiber_tpu_torch import entry, run_es
    from fiber_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (resolve_device, lambda: TinyLM(**SMALL), entry,
                 lambda: run_es(pop=4, max_steps=2)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
