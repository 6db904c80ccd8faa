"""Where the port's entry points run.

They run on the card unless the caller names another device: the plain
PyTorch path on the CPU is there for tests and is never taken silently.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, and raises
    when there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: the port runs on the card by "
            "default; pass device='cpu' explicitly for the plain PyTorch "
            "path")
    return torch.device("cuda")
