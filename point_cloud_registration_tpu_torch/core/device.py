"""Which device an entry point runs on.

Entry points run on the card unless the caller asks for the CPU: a tensor
keeps its device, a NumPy input goes to :func:`default_device`.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA card when there is one, else the CPU."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def resolve_device(points=None, device=None) -> torch.device:
    """``device`` when given; else the device of ``points`` when it is a
    tensor; else :func:`default_device`."""
    if device is not None:
        return torch.device(device)
    if isinstance(points, torch.Tensor):
        return points.device
    return default_device()
