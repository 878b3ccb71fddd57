"""The device mesh of the population plane: one ``pool`` axis.

Counterpart of ``fiber_tpu/parallel/mesh.py``. This slice of the port
runs on one card, so the axis holds one device; a mesh over several
GPUs (one process each, in a ``torch.distributed`` group) is the
multi-GPU slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from fiber_tpu_torch.device import resolve_device

POOL_AXIS = "pool"


@dataclass(frozen=True)
class Mesh:
    devices: Tuple[torch.device, ...]
    axis: str = POOL_AXIS

    @property
    def n_dev(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """This process's device on the axis."""
        return self.devices[0]


def make_mesh(device=None) -> Mesh:
    """A one-device ``pool`` axis on ``device`` (CUDA unless the caller
    asks for the CPU)."""
    return Mesh((resolve_device(device),))
