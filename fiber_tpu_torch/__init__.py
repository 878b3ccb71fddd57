"""fiber_tpu_torch: the port of fiber_tpu's device plane to PyTorch and
CUDA on an NVIDIA H100.

The JAX package ``fiber_tpu`` stays the reference; this package imports
nothing of it and no JAX. Every entry point takes ``device=``: CUDA by
default, the CPU only when asked (there every kernel wrapper runs its
plain PyTorch version). Kernels are compiled from ``csrc/`` by ``nvcc``
at first use.

Ported so far: the one-device OpenAI-ES flagship, and TinyLM with flash
attention, forward, KV-cache decoding and training (``flash_fwd``,
``flash_bwd_dq`` and ``flash_bwd_dkv``; ``make_train_step``,
``train_lm``).
"""

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.entry import entry, run_es, train_lm
from fiber_tpu_torch.models.convert import (
    policy_params_from_jax,
    tinylm_params_from_jax,
    tinylm_tree_from_torch,
)
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.models.transformer import TinyLM, adamw, make_train_step
from fiber_tpu_torch.ops.es import (
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
from fiber_tpu_torch.ops.ring_attention import reference_attention

__all__ = [
    "CartPole", "EvolutionStrategy", "MLPPolicy", "TinyLM", "adamw",
    "apply_es_update", "centered_rank", "entry", "flash_attention",
    "flash_attention_bwd_reference", "flash_attention_lse",
    "flash_attention_reference", "flash_bwd_dkv", "flash_bwd_dq",
    "flash_fwd", "make_train_step", "policy_params_from_jax",
    "reference_attention", "resolve_device", "run_es",
    "tinylm_params_from_jax", "tinylm_tree_from_torch", "train_lm",
]
