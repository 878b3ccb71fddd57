"""fiber_tpu_torch: the port of fiber_tpu's device plane to PyTorch and
CUDA on an NVIDIA H100.

The JAX package ``fiber_tpu`` stays the reference; this package imports
nothing of it and no JAX. Every entry point takes ``device=``: CUDA by
default, the CPU only when asked (there every kernel wrapper runs its
plain PyTorch version). Kernels are compiled from ``csrc/`` by ``nvcc``
at first use.

This slice holds the flash-attention LM forward (``TinyLM`` with the
``flash_fwd`` kernel) and the one-device OpenAI-ES flagship.
"""

from fiber_tpu_torch.device import resolve_device
from fiber_tpu_torch.entry import entry, run_es
from fiber_tpu_torch.models.convert import (
    policy_params_from_jax,
    tinylm_params_from_jax,
)
from fiber_tpu_torch.models.envs import CartPole
from fiber_tpu_torch.models.policies import MLPPolicy
from fiber_tpu_torch.models.transformer import TinyLM
from fiber_tpu_torch.ops.es import (
    EvolutionStrategy,
    apply_es_update,
    centered_rank,
)
from fiber_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_lse,
    flash_attention_reference,
    flash_fwd,
)
from fiber_tpu_torch.ops.ring_attention import reference_attention

__all__ = [
    "CartPole", "EvolutionStrategy", "MLPPolicy", "TinyLM",
    "apply_es_update", "centered_rank", "entry", "flash_attention",
    "flash_attention_lse", "flash_attention_reference", "flash_fwd",
    "policy_params_from_jax", "reference_attention", "resolve_device",
    "run_es", "tinylm_params_from_jax",
]
