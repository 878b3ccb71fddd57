"""The device mesh of the port and ``Pool.map`` lowered onto it."""

from fiber_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    mesh_for,
    shard,
    unshard,
)
from fiber_tpu_torch.parallel.dmap import (  # noqa: F401
    DeviceMapPlan,
    device_map,
)
