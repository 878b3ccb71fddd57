"""The port's TinyLM over an 8-rank CPU mesh against the JAX TinyLM over
the 8-device CPU mesh, on one set of weights (drawn with numpy, loaded
into both): the ``"ring"``, ``"ulysses"`` and multi-rank ``"flash"``
planes, MHA and GQA. The JAX flash plane runs its Pallas kernel in
interpret mode; the port runs the kernels' plain versions.

Tolerance: logits and loss within 1e-4 (``test_torch_transformer.py``'s
bound for two attention engines; logits are O(0.1) at these weights).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from fiber_tpu.models.transformer import TinyLM as JaxTinyLM

from fiber_tpu_torch.models import convert
from fiber_tpu_torch.models.transformer import TinyLM
from fiber_tpu_torch.parallel.mesh import Mesh, make_mesh

N = 8
# heads divisible by the 8 ranks, as the Ulysses plane needs
SMALL = dict(vocab=32, dim=64, heads=8, layers=2, max_seq=64)
TOL = 1e-4

# (attention, pos, kv_heads)
CASES = {
    "ring_learned": ("ring", "learned", None),
    "ring_rope_gqa": ("ring", "rope", 2),
    "ulysses_learned": ("ulysses", "learned", None),
    "ulysses_rope_gqa": ("ulysses", "rope", 4),
    "flash_learned": ("flash", "learned", None),
    "flash_rope_gqa": ("flash", "rope", 2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_tinylm_matches_jax(case):
    attention, pos, kv_heads = CASES[case]
    tree = convert.random_tinylm_tree(**SMALL, kv_heads=kv_heads, pos=pos,
                                      seed=0)
    jm = JaxTinyLM(**SMALL, attention=attention, pos=pos, kv_heads=kv_heads,
                   mesh=JaxMesh(np.asarray(jax.devices()[:N]), ("pool",)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    model = TinyLM(**SMALL, attention=attention, pos=pos, kv_heads=kv_heads,
                   mesh=make_mesh("cpu", n=N))
    model.load_state_dict(convert.tinylm_params_from_jax(tree,
                                                         device="cpu"))
    tokens = np.random.default_rng(1).integers(0, SMALL["vocab"],
                                               SMALL["max_seq"])
    want = np.asarray(jax.device_get(jm.apply(jparams, jnp.asarray(tokens))))
    with torch.no_grad():
        got = model.apply(torch.from_numpy(tokens)).numpy()
        loss = model.loss(torch.from_numpy(tokens)).item()
    assert got.shape == (SMALL["max_seq"], SMALL["vocab"])
    assert np.abs(got - want).max() < TOL
    assert abs(loss - float(jm.loss(jparams, jnp.asarray(tokens)))) < TOL


def test_mesh_tinylm_errors():
    mesh = make_mesh("cpu", n=N)
    with pytest.raises(ValueError, match="window"):
        TinyLM(**SMALL, attention="flash", window=8, mesh=mesh)
    with pytest.raises(ValueError, match="'pool' axis"):
        TinyLM(**SMALL, attention="ring",
               mesh=Mesh((torch.device("cpu"),) * 2, axis="seq"))
    with pytest.raises(ValueError, match="unknown attention"):
        TinyLM(**SMALL, attention="nope", device="cpu")
    with pytest.raises(ValueError, match="not the mesh's device"):
        TinyLM(**SMALL, attention="ring", device="cpu",
               mesh=Mesh((torch.device("cuda", 0),)))
    # one rank keeps the window; a one-rank mesh of any axis name is fine
    TinyLM(**SMALL, attention="flash", window=8, mesh=make_mesh("cpu"))
    one = TinyLM(**SMALL, attention="ring",
                 mesh=Mesh((torch.device("cpu"),), axis="seq"))
    assert one.mesh.n_dev == 1 and one.device == torch.device("cpu")
