"""fiber_tpu_torch: the port of fiber_tpu's device plane to PyTorch and
CUDA on an NVIDIA H100.

The JAX package ``fiber_tpu`` stays the reference; this package imports
nothing of it and no JAX. Every entry point takes ``device=``: CUDA by
default, the CPU only when asked (there every kernel wrapper runs its
plain PyTorch version). Kernels are compiled from ``csrc/`` by ``nvcc``
at first use.

Ported so far: the OpenAI-ES flagship, on one rank or over a mesh;
TinyLM with flash attention, forward, KV-cache decoding and training
(``flash_fwd``, ``flash_bwd_dq`` and ``flash_bwd_dkv``;
``make_train_step``, ``train_lm``); and the sequence-parallel planes
over a single-controller mesh of n ranks (``make_mesh``,
``ring_attention``, ``ulysses_attention``, TinyLM's ``"ring"``,
``"ulysses"`` and multi-rank ``"flash"``), whose rotations run the
``ring_exchange`` kernel whenever no gradient is needed; and the
population-search families beside the ES flagship (``AskTellES`` for
evaluators on the host, ``device_map``/``DeviceMapPlan``, ``PGPE``,
``SepCMAES``, ``CMAES``, ``NoveltyES`` with ``knn_novelty`` and
``NoveltyPopulation``, ``MAPElites``, and the ``DeceptiveMaze`` that
the novelty and MAP-Elites examples search); and POET (``POET``,
``run_poet``) with the evolvable envs (``ParamCartPole``,
``ParamHillWalker``, ``ParamBipedWalker``), ``Pendulum``, ``PixelChase``
with ``ConvPolicy``, ``GRUPolicy`` with ``rollout_recurrent``, and the
policies' ``compute_dtype``; ``run_es(env=...)`` runs ``bench.py``'s
``--biped`` and ``--pixels`` ES. Beside them: ``POET`` over a mesh
(``run_poet(ranks=)``), the rate fields of ``run_es``/``run_poet``
(model FLOP/s and MFU, ``utils/flops.py``), checkpoints of ES and POET
state (``utils/checkpoint.py``), the profiling hooks
(``utils/profiling.py``) and grid meshes (``make_mesh(shape=,
names=)``) with data x sequence ring and Ulysses attention.
"""

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.entry import (
    entry,
    make_es,
    make_poet,
    run_es,
    run_poet,
    train_lm,
)
from fiber_tpu_torch.models.convert import (
    poet_state_from_jax,
    policy_params_from_jax,
    state_from_jax,
    tinylm_params_from_jax,
    tinylm_tree_from_torch,
)
from fiber_tpu_torch.models.envs import (
    CartPole,
    DeceptiveMaze,
    ParamBipedWalker,
    ParamCartPole,
    ParamHillWalker,
    Pendulum,
    PixelChase,
    mutate_bounded,
    rollout_recurrent,
)
from fiber_tpu_torch.models.policies import ConvPolicy, GRUPolicy, MLPPolicy
from fiber_tpu_torch.models.transformer import TinyLM, adamw, make_train_step
from fiber_tpu_torch.ops.cma import CMAES, SepCMAES
from fiber_tpu_torch.ops.es import (
    AskTellES,
    EvolutionStrategy,
    apply_es_update,
    centered_rank,
)
from fiber_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bwd_reference,
    flash_attention_lse,
    flash_attention_reference,
    flash_bwd_dkv,
    flash_bwd_dq,
    flash_fwd,
)
from fiber_tpu_torch.ops.dma_ring import ring_all_to_all, ring_exchange
from fiber_tpu_torch.ops.map_elites import MAPElites, MapElitesState
from fiber_tpu_torch.ops.novelty import (
    NoveltyES,
    NoveltyPopulation,
    NoveltyState,
    knn_novelty,
)
from fiber_tpu_torch.ops.pgpe import PGPE
from fiber_tpu_torch.ops.poet import POET
from fiber_tpu_torch.ops.ring_attention import (
    blockwise_attention,
    reference_attention,
    ring_attention,
    ring_attention_local,
)
from fiber_tpu_torch.ops.ulysses_attention import (
    ulysses_attention,
    ulysses_attention_local,
)
from fiber_tpu_torch.parallel.dmap import DeviceMapPlan, device_map
from fiber_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    mesh_shape,
    shard,
    shard_grid,
    unshard,
    unshard_grid,
)

__all__ = [
    "AskTellES", "CMAES", "CartPole", "ConvPolicy", "DeceptiveMaze",
    "DeviceMapPlan", "EvolutionStrategy", "GRUPolicy", "MAPElites",
    "MLPPolicy", "MapElitesState", "Mesh", "NoveltyES", "NoveltyPopulation",
    "NoveltyState", "PGPE", "POET", "ParamBipedWalker", "ParamCartPole",
    "ParamHillWalker", "Pendulum", "PixelChase", "SepCMAES",
    "TinyLM", "adamw", "apply_es_update", "blockwise_attention",
    "centered_rank", "device_map", "entry", "flash_attention",
    "flash_attention_bwd_reference", "flash_attention_lse",
    "flash_attention_reference", "flash_bwd_dkv", "flash_bwd_dq",
    "flash_fwd", "knn_novelty", "make_es", "make_mesh", "make_poet",
    "make_train_step", "mesh_shape", "mutate_bounded",
    "poet_state_from_jax",
    "policy_params_from_jax", "reference_attention", "resolve_device",
    "ring_all_to_all", "ring_attention", "ring_attention_local",
    "ring_exchange", "rollout_recurrent", "run_es", "run_poet", "shard",
    "shard_grid", "state_from_jax",
    "tinylm_params_from_jax", "tinylm_tree_from_torch", "train_lm",
    "ulysses_attention", "ulysses_attention_local", "unshard",
    "unshard_grid",
]
