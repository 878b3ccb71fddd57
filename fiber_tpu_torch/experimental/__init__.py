"""API-parity shim: the reference exposes Ring under
``fiber.experimental`` (fiber/experimental/__init__.py); the port's Ring
lives in ``fiber_tpu_torch.parallel`` but remains importable from here,
with ``torch_distributed_initializer`` where the JAX package has its
``jax_distributed_initializer``."""

from fiber_tpu_torch.parallel.ring import Ring, RingNode  # noqa: F401
from fiber_tpu_torch.parallel.ring import (  # noqa: F401
    current_ring,
    default_initializer,
    torch_distributed_initializer,
)
