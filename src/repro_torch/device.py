"""The device an entry point runs on: ``cuda`` unless the caller asks
for the CPU, and never the CPU in silence."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(name) -> torch.device:
    """The device named; ``cuda`` without a GPU raises."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device cuda asked for, but no CUDA device is "
                           "available (ask for device cpu for a CPU run)")
    return dev
