"""ResNets — counterparts of ``fedml_tpu/models/cv/resnet.py``: the CIFAR
6n+2 ResNets (20, 56) and ResNet-18, with GroupNorm (``groups=2`` by
default) or, with ``groups`` None, the reference's BatchNorm over running
averages, which the port does not have (it raises). Inputs are NHWC."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from fedml_tpu_torch.models.layers import (
    Scope,
    conv,
    dense,
    group_norm,
    max_pool,
    nhwc_to_nchw,
)


def _norm(s: Scope, x: torch.Tensor, groups: Optional[int]) -> torch.Tensor:
    if not groups:
        raise NotImplementedError(
            "BatchNorm ResNets (group_norm_channels 0) come with the rest of "
            "the model zoo (ROADMAP A13); use GroupNorm")
    return group_norm(s, x, groups)


def basic_block(s: Scope, x: torch.Tensor, filters: int, stride: int = 1,
                groups: Optional[int] = 2) -> torch.Tensor:
    b = s.sub("BasicBlock")
    residual = x
    y = conv(b, x, filters, (3, 3), (stride, stride), use_bias=False)
    y = torch.relu(_norm(b, y, groups))
    y = conv(b, y, filters, (3, 3), use_bias=False)
    y = _norm(b, y, groups)
    if residual.shape != y.shape:
        residual = conv(b, x, filters, (1, 1), (stride, stride), use_bias=False)
        residual = _norm(b, residual, groups)
    return torch.relu(y + residual)


@dataclass(frozen=True)
class ResNetCifar:
    """6n+2 CIFAR ResNet (n=3 → resnet20, n=9 → resnet56)."""

    n: int = 3
    output_dim: int = 10
    groups: Optional[int] = 2

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x)
        x = conv(s, x, 16, (3, 3), use_bias=False)
        x = torch.relu(_norm(s, x, self.groups))
        for filters, stride in ((16, 1), (32, 2), (64, 2)):
            for i in range(self.n):
                x = basic_block(s, x, filters, stride if i == 0 else 1, self.groups)
        return dense(s, x.mean((2, 3)), self.output_dim)


@dataclass(frozen=True)
class ResNet18:
    """torchvision-shape ResNet-18 for 32×32 (3×3 stem) or larger inputs
    (7×7 stride-2 stem and a max pool)."""

    output_dim: int = 10
    groups: Optional[int] = 2
    stage_sizes: Sequence[int] = (2, 2, 2, 2)

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        small = x.shape[1] <= 64
        x = nhwc_to_nchw(x)
        if small:
            x = conv(s, x, 64, (3, 3), use_bias=False)
        else:
            x = conv(s, x, 64, (7, 7), (2, 2), use_bias=False)
        x = torch.relu(_norm(s, x, self.groups))
        if not small:
            x = max_pool(x, (3, 3), (2, 2), padding="SAME")
        for stage, blocks in enumerate(self.stage_sizes):
            for i in range(blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                x = basic_block(s, x, 64 * 2 ** stage, stride, self.groups)
        return dense(s, x.mean((2, 3)), self.output_dim)


def resnet20(output_dim=10, groups=2):
    return ResNetCifar(n=3, output_dim=output_dim, groups=groups)


def resnet56(output_dim=100, groups=2):
    return ResNetCifar(n=9, output_dim=output_dim, groups=groups)


def resnet18(output_dim=10, groups=2):
    return ResNet18(output_dim=output_dim, groups=groups)
