"""Device resolution for the port's entry points.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Without a
CUDA device it raises unless the caller asked for the CPU explicitly: the
port never moves to the CPU behind the caller's back.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: the port runs on cuda or cpu")
    return dev
