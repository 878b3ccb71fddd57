"""Device selection for every entry point of the port.

The port runs on the GPU. The CPU is used only when a caller asks for it
by name (the CPU tests do), and then every kernel wrapper takes its plain
PyTorch version. There is no silent fallback: asking for CUDA on a
machine without it raises.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` and ``"cuda"`` mean the current CUDA device; ``"cpu"``
    means the CPU. Raises when CUDA was asked for (or left as the
    default) and is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
