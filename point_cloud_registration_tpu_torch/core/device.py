"""Which device an entry point runs on.

Entry points run on the card unless the caller asks for the CPU: a tensor
keeps its device, a NumPy input goes to :func:`default_device`, which is
the card or an error, never the CPU on its own.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first CUDA card. Raises ``RuntimeError`` when no CUDA device is
    usable: a caller that means the CPU names ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is usable; pass device='cpu' to run on the CPU")
    return torch.device("cuda")


def resolve_device(points=None, device=None) -> torch.device:
    """``device`` when given; else the device of ``points`` when it is a
    tensor; else :func:`default_device`."""
    if device is not None:
        return torch.device(device)
    if isinstance(points, torch.Tensor):
        return points.device
    return default_device()
