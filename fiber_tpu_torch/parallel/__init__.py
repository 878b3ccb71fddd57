"""The device mesh of the port, ``Pool.map`` lowered onto it, and
``Ring``, the reference's SPMD topology builder.

The names resolve at their first use: a ``Ring`` rank whose work needs
only numpy imports ``parallel.ring`` without torch."""

import importlib as _importlib

#: name -> the submodule that defines it
_LAZY = {
    **dict.fromkeys(("Mesh", "default_mesh", "make_mesh", "mesh_for",
                     "mesh_from_config", "reset_default_mesh", "shard",
                     "unshard"), "mesh"),
    **dict.fromkeys(("DeviceMapPlan", "device_map"), "dmap"),
    **dict.fromkeys(("Ring", "RingNode"), "ring"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    module = _LAZY.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(_importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value
