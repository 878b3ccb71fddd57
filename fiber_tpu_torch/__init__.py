"""fiber_tpu_torch: the port of fiber_tpu to PyTorch and CUDA on an
NVIDIA H100.

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

The host plane of the user API is here too, as in the JAX package:
``Process``, ``Pool``, ``SimpleQueue``, ``Pipe``, ``meta``, ``config``
and ``init``. A ``Pool`` runs plain functions on local worker processes
(``python -m fiber_tpu_torch.worker``), and a function marked
``@meta(device=True)`` through ``device_map`` on the pool's device,
with no worker process. Torch tensors cross the wire as tensors
(``serialization``). ``Manager`` and ``AsyncManager`` serve shared
objects to every process. ``parallel.Ring`` runs one function in n rank
processes, joined by a ``HostRing`` (``current_ring().allreduce``) or
by ``torch.distributed`` over gloo (``torch_distributed_initializer``),
whose default group a process mesh (``make_mesh(group=)``) spans, so
that the ES runs across the ranks. ``fiber_tpu_torch.examples`` holds
the Pool-driven POET and the ring examples. The ``tpu`` backend is not
ported yet.

Importing the package imports no torch: the device-plane names below
resolve at their first use, so that a worker whose tasks need only
numpy never pays for it.
"""

import importlib as _importlib
import os as _os
import sys as _sys
import types as _types

__version__ = "0.1.0"

from fiber_tpu_torch import config  # noqa: F401,E402
from fiber_tpu_torch.meta import meta  # noqa: F401,E402
from fiber_tpu_torch.telemetry.accounting import CostBudget  # noqa: F401,E402
from fiber_tpu_torch.context import FiberContext as _FiberContext  # noqa: E402

_default_context = _FiberContext()

# The context API, hoisted as the JAX package hoists it.
Process = _default_context.Process
Pool = _default_context.Pool
Manager = _default_context.Manager
AsyncManager = _default_context.AsyncManager
SimpleQueue = _default_context.SimpleQueue
Pipe = _default_context.Pipe
cpu_count = _default_context.cpu_count
current_process = _default_context.current_process
active_children = _default_context.active_children
get_context = _default_context.get_context

in_worker = _os.environ.get("FIBER_WORKER", "") not in ("", "0")


def init(**kwargs):
    """(Re)initializes the package: applies config overrides and resets
    logging and telemetry."""
    from fiber_tpu_torch.utils import logging as _fl
    from fiber_tpu_torch import telemetry as _telemetry

    config.init(**kwargs)
    _fl.init_logger(config.get())
    _telemetry.refresh()


def reset():
    """Resets config back to defaults (env/file reapply on next init)."""
    config.reset()


#: device-plane name -> the module that defines it, imported at first use
_LAZY = {
    "resolve_device": "device",
    **dict.fromkeys(("entry", "make_es", "make_poet", "run_es", "run_poet",
                     "train_lm"), "entry"),
    **dict.fromkeys(("poet_state_from_jax", "policy_params_from_jax",
                     "state_from_jax", "tinylm_params_from_jax",
                     "tinylm_tree_from_torch"), "models.convert"),
    **dict.fromkeys(("CartPole", "DeceptiveMaze", "ParamBipedWalker",
                     "ParamCartPole", "ParamHillWalker", "Pendulum",
                     "PixelChase", "mutate_bounded", "rollout_recurrent"),
                    "models.envs"),
    **dict.fromkeys(("ConvPolicy", "GRUPolicy", "MLPPolicy"),
                    "models.policies"),
    **dict.fromkeys(("TinyLM", "adamw", "make_train_step"),
                    "models.transformer"),
    **dict.fromkeys(("CMAES", "SepCMAES"), "ops.cma"),
    **dict.fromkeys(("AskTellES", "EvolutionStrategy", "apply_es_update",
                     "centered_rank"), "ops.es"),
    **dict.fromkeys(("flash_attention", "flash_attention_bwd_reference",
                     "flash_attention_lse", "flash_attention_reference",
                     "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd"),
                    "ops.flash_attention"),
    **dict.fromkeys(("ring_all_to_all", "ring_exchange"), "ops.dma_ring"),
    **dict.fromkeys(("MAPElites", "MapElitesState"), "ops.map_elites"),
    **dict.fromkeys(("NoveltyES", "NoveltyPopulation", "NoveltyState",
                     "knn_novelty"), "ops.novelty"),
    "PGPE": "ops.pgpe",
    "POET": "ops.poet",
    **dict.fromkeys(("blockwise_attention", "reference_attention",
                     "ring_attention", "ring_attention_local"),
                    "ops.ring_attention"),
    **dict.fromkeys(("ulysses_attention", "ulysses_attention_local"),
                    "ops.ulysses_attention"),
    **dict.fromkeys(("DeviceMapPlan", "device_map"), "parallel.dmap"),
    **dict.fromkeys(("Mesh", "make_mesh", "mesh_shape", "shard",
                     "shard_grid", "unshard", "unshard_grid"),
                    "parallel.mesh"),
}


class _Package(_types.ModuleType):
    """The package's module type. Its one change: importing the
    submodule ``entry`` does not hide the function ``entry``, which the
    package's namespace has named since before the names were lazy."""

    def __setattr__(self, name, value):
        if name in _LAZY and isinstance(value, _types.ModuleType):
            return
        super().__setattr__(name, value)


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(_importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


_sys.modules[__name__].__class__ = _Package

__all__ = [
    "AsyncManager", "CostBudget", "Manager", "Pipe", "Pool", "Process",
    "SimpleQueue",
    "active_children", "config", "cpu_count", "current_process",
    "get_context", "init", "meta", "reset", *sorted(_LAZY),
]

# Master-process logger init at import, as in the JAX package: workers
# re-init inside the spawn bootstrap with the shipped config instead.
if not in_worker:
    from fiber_tpu_torch.utils import logging as _fl

    _fl.init_logger(config.get())
del _os
