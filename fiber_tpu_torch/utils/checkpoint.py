"""Checkpoints of device-plane state: ES and POET search states.

Counterpart of ``fiber_tpu/utils/checkpoint.py``, in the same file
layout: one ``.npz`` holding the leaves as ``leaf_0``, ``leaf_1``, ...
and a JSON skeleton of the containers as ``__structure__`` (uint8
bytes), written atomically (a temporary file, then ``os.replace``) and
read with ``allow_pickle=False``. So a file written by either package
loads in the other wherever the leaves match, and loading an untrusted
file runs no code. Containers are dict, list and tuple; leaves are
tensors, arrays and scalars of a dtype numpy stores without pickle
(a bfloat16 tensor raises).

Where the JAX package's ``key`` slot holds a PRNG key, the port's holds
generator states (``torch.Generator.get_state()``): the ES's device
generator, and for POET also its CPU ``pick_generator``. A resumed run
that restores them draws what the uninterrupted run draws.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch

_LEAF = "__leaf__:"


def _leaf(obj) -> np.ndarray:
    """A leaf as the numpy array the file stores."""
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            raise TypeError(
                "a bfloat16 tensor has no numpy dtype that loads without "
                "pickle; cast it to float32 before saving")
        return obj.detach().cpu().numpy()
    if isinstance(obj, torch.Generator):
        return obj.get_state().numpy()
    return np.asarray(obj)


def _encode(obj: Any, leaves: list) -> Any:
    """The structure skeleton as plain JSON, every array-like replaced by
    a leaf placeholder. Only dict, list and tuple containers."""
    if isinstance(obj, dict):
        return {str(k): _encode(v, leaves) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        kind = "list" if isinstance(obj, list) else "tuple"
        return {"__seq__": kind,
                "items": [_encode(v, leaves) for v in obj]}
    if obj is None:
        return None
    leaf = _leaf(obj)
    if leaf.dtype.hasobject:
        raise TypeError(f"cannot checkpoint a leaf of dtype {leaf.dtype} "
                        "without pickle")
    leaves.append(leaf)
    return _LEAF + str(len(leaves) - 1)


def _decode(node: Any, leaves: list) -> Any:
    if isinstance(node, dict):
        if "__seq__" in node:
            items = [_decode(v, leaves) for v in node["items"]]
            return tuple(items) if node["__seq__"] == "tuple" else items
        return {k: _decode(v, leaves) for k, v in node.items()}
    if isinstance(node, str) and node.startswith(_LEAF):
        return leaves[int(node[len(_LEAF):])]
    if node is None:
        return None
    raise ValueError(f"corrupt checkpoint structure node: {node!r}")


def save(path: str, tree: Any) -> None:
    """Atomically writes a tree (dict/list/tuple of tensors, arrays,
    scalars and generators, whose state is stored) to ``path``
    (.npz)."""
    leaves: list = []
    skeleton = _encode(tree, leaves)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["__structure__"] = np.frombuffer(
        json.dumps(skeleton).encode(), dtype=np.uint8)
    tmp = f"{path}.tmp.{os.getpid()}"
    directory = os.path.dirname(os.path.abspath(path))
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    os.replace(tmp, path)


def load(path: str, device=None) -> Any:
    """Loads a tree saved by :func:`save` (or by the JAX package's).
    Leaves are numpy arrays, or with ``device`` tensors on it."""
    with np.load(path, allow_pickle=False) as data:
        skeleton = json.loads(data["__structure__"].tobytes().decode())
        n = len([k for k in data.files if k.startswith("leaf_")])
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    if device is not None:
        leaves = [torch.from_numpy(leaf).to(device) for leaf in leaves]
    return _decode(skeleton, leaves)


def _generator_state(leaf) -> torch.Tensor:
    """A stored generator state as ``set_state`` takes it: a uint8
    tensor on the CPU."""
    return torch.as_tensor(leaf).to("cpu", torch.uint8)


def save_es_state(path: str, params, key, generation: int,
                  extra: Any = None) -> None:
    """An ES checkpoint: ``params``, ``key`` (the strategy's generator,
    or its state), the generation and ``extra`` (the Adam state ``(m, v,
    t)`` of ``EvolutionStrategy._opt_state``, or anything else)."""
    save(path, {
        "params": params,
        "key": key,
        "generation": np.asarray(generation),
        "extra": extra if extra is not None else np.asarray(0),
    })


def load_es_state(path: str, device=None):
    """Returns ``(params, key, generation, extra)`` of
    :func:`save_es_state`: ``params`` and ``extra`` as :func:`load` gives
    them, ``key`` as a CPU uint8 tensor for ``Generator.set_state``."""
    state = load(path, device)
    return (state["params"], _generator_state(state["key"]),
            int(state["generation"]), state.get("extra"))


def save_poet_state(path: str, poet, iteration: int) -> None:
    """A :class:`fiber_tpu_torch.ops.poet.POET` checkpoint: the active
    pairs, the novelty archive, the iteration and the states of its
    device ``generator`` and CPU ``pick_generator`` (the ``key`` slot)."""
    save(path, {
        "envs": list(poet.envs),
        "agents": list(poet.agents),
        "archive": list(poet.archive),
        "key": (poet.generator, poet.pick_generator),
        "iteration": np.asarray(iteration),
    })


def load_poet_state(path: str, poet):
    """Restores :func:`save_poet_state`'s state into ``poet`` (built with
    the same env class, policy and shapes): pairs on its device, the
    archive as float64 numpy, both generators. Returns ``(key,
    iteration)``, the key as the two restored generator states."""
    state = load(path)
    poet.envs = [torch.from_numpy(e).to(poet.device) for e in state["envs"]]
    poet.agents = [torch.from_numpy(a).to(poet.device)
                   for a in state["agents"]]
    poet.archive = [np.asarray(a, dtype=float) for a in state["archive"]]
    key = tuple(_generator_state(k) for k in state["key"])
    poet.generator.set_state(key[0])
    poet.pick_generator.set_state(key[1])
    return key, int(state["iteration"])
