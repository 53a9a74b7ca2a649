"""Device selection shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises instead of quietly running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"repro_torch: device {str(dev)!r} requested but no CUDA device "
            "is available; pass device='cpu' to run on the CPU")
    return dev
