"""Carry parameters between the JAX package and the port.

Parameters cross as numpy arrays (``jax.device_get`` on the JAX side),
in both directions, so this module needs no JAX. Layouts are the same
in both packages: weights ``(in, out)``, MLP policies one flat vector
in ``MLPPolicy.init`` order.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fiber_tpu_torch.device import resolve_device


def tinylm_params_from_jax(np_tree: dict, device=None) -> dict:
    """A JAX ``TinyLM.init`` tree (numpy leaves) -> a state dict for
    :class:`fiber_tpu_torch.models.TinyLM` (``model.load_state_dict``)."""
    dev = resolve_device(device)

    def t(a):
        return torch.from_numpy(np.array(a, copy=True)).to(dev)

    state = {name: t(np_tree[name]) for name in ("embed", "out",
                                                 "final_norm")}
    if "pos" in np_tree:
        state["pos"] = t(np_tree["pos"])
    for i, blk in enumerate(np_tree["blocks"]):
        for name, a in blk.items():
            state[f"blocks.{i}.{name}"] = t(a)
    return state


def tinylm_tree_from_torch(model) -> dict:
    """A :class:`fiber_tpu_torch.models.TinyLM` (or its state dict) -> a
    numpy tree in the JAX ``TinyLM.init`` layout: the inverse of
    :func:`tinylm_params_from_jax`."""
    state = model.state_dict() if hasattr(model, "state_dict") else model
    tree = {"blocks": []}
    for name, t in state.items():
        a = t.detach().cpu().numpy().copy()
        if not name.startswith("blocks."):
            tree[name] = a
            continue
        _, i, leaf = name.split(".")
        while len(tree["blocks"]) <= int(i):
            tree["blocks"].append({})
        tree["blocks"][int(i)][leaf] = a
    return tree


def policy_params_from_jax(np_vec, device=None) -> torch.Tensor:
    """A flat policy vector (or a (pop, dim) batch) -> f32 tensor."""
    return torch.as_tensor(np.array(np_vec, np.float32, copy=True),
                           device=resolve_device(device))


def random_tinylm_tree(vocab: int, dim: int, heads: int, layers: int,
                       max_seq: int, mlp_mult: int = 4,
                       kv_heads: Optional[int] = None, pos: str = "learned",
                       seed: int = 0) -> dict:
    """A random parameter tree in the JAX ``TinyLM.init`` layout, drawn
    with numpy from ``seed``: the one set of weights that both packages
    (and the chip smoke) load. Norm gains and biases are drawn too, so a
    comparison exercises them."""
    rng = np.random.default_rng(seed)
    kv_heads = kv_heads or heads

    def w(*shape):
        return (0.02 * rng.standard_normal(shape)).astype(np.float32)

    def gain(n):
        return (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32)

    tree = {"embed": w(vocab, dim), "out": w(dim, vocab),
            "final_norm": gain(dim), "blocks": []}
    if pos == "learned":
        tree["pos"] = w(max_seq, dim)
    hidden = mlp_mult * dim
    for _ in range(layers):
        blk = {"norm1": gain(dim), "wo": w(dim, dim), "norm2": gain(dim),
               "w1": w(dim, hidden), "b1": w(hidden), "w2": w(hidden, dim),
               "b2": w(dim)}
        if kv_heads == heads:
            blk["wqkv"] = w(dim, 3 * dim)
        else:
            blk["wq"] = w(dim, dim)
            blk["wkv"] = w(dim, 2 * kv_heads * (dim // heads))
        tree["blocks"].append(blk)
    return tree
