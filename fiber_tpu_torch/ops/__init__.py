"""Kernels and plain tensor ops of the port. Exported here, as
``fiber_tpu.ops`` exports them: the sharded collectives, the
population-search families and POET. The attention planes' functions
stay in their modules (``ops.ring_attention``,
``ops.ulysses_attention``), since a function exported under its
module's name would hide the module; the package root exports them."""

from fiber_tpu_torch.ops.collectives import (  # noqa: F401
    all_gather_sharded,
    pmean_sharded,
    psum_sharded,
)
from fiber_tpu_torch.ops.es import (  # noqa: F401
    AskTellES,
    EvolutionStrategy,
    centered_rank,
)
from fiber_tpu_torch.ops.pgpe import PGPE  # noqa: F401
from fiber_tpu_torch.ops.poet import POET  # noqa: F401
from fiber_tpu_torch.ops.cma import CMAES, SepCMAES  # noqa: F401
from fiber_tpu_torch.ops.novelty import (  # noqa: F401
    NoveltyES,
    NoveltyPopulation,
    NoveltyState,
    knn_novelty,
)
from fiber_tpu_torch.ops.map_elites import (  # noqa: F401
    MAPElites,
    MapElitesState,
)
