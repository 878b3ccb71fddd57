"""Kernels and plain tensor ops of the port. Exported here, as
``fiber_tpu.ops`` exports them: the sharded collectives, the
population-search families and POET. The attention planes' functions
stay in their modules (``ops.ring_attention``,
``ops.ulysses_attention``), since a function exported under its
module's name would hide the module; the package root exports them.

The names resolve at their first use, so that importing
``ops.collectives`` for its ``HostRing`` imports no torch."""

import importlib as _importlib

#: name -> the submodule that defines it
_LAZY = {
    **dict.fromkeys(("all_gather_sharded", "pmean_sharded", "psum_sharded",
                     "HostRing"), "collectives"),
    **dict.fromkeys(("AskTellES", "EvolutionStrategy", "centered_rank"),
                    "es"),
    "PGPE": "pgpe",
    "POET": "poet",
    **dict.fromkeys(("CMAES", "SepCMAES"), "cma"),
    **dict.fromkeys(("NoveltyES", "NoveltyPopulation", "NoveltyState",
                     "knn_novelty"), "novelty"),
    **dict.fromkeys(("MAPElites", "MapElitesState"), "map_elites"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(_importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
