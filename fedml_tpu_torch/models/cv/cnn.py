"""CNNs — counterparts of ``fedml_tpu/models/cv/cnn.py``: the FedAvg
paper's FEMNIST CNN, LeNet-5 and the CIFAR CNN. Inputs are NHWC, as the
loaders give them; the models run NCHW (``models/layers.py``)."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from fedml_tpu_torch.models.layers import (
    Scope,
    conv,
    dense,
    flatten_nchw,
    max_pool,
    nhwc_to_nchw,
)


def _image(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 2:  # flat 784 → 28×28×1
        side = int(math.isqrt(x.shape[-1]))
        x = x.reshape(x.shape[0], side, side, 1)
    return nhwc_to_nchw(x)


@dataclass(frozen=True)
class CNNFemnist:
    """Conv(32,5x5)-pool-Conv(64,5x5)-pool-Dense(2048)-Dense(out). Dropout
    (the reference's option, off by default) is not ported."""

    output_dim: int = 62

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        x = _image(x)
        x = max_pool(torch.relu(conv(s, x, 32, (5, 5))), (2, 2), (2, 2))
        x = max_pool(torch.relu(conv(s, x, 64, (5, 5))), (2, 2), (2, 2))
        x = torch.relu(dense(s, flatten_nchw(x), 2048))
        return dense(s, x, self.output_dim)


@dataclass(frozen=True)
class LeNet5:
    output_dim: int = 10

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        x = _image(x)
        x = max_pool(torch.relu(conv(s, x, 6, (5, 5))), (2, 2), (2, 2))
        x = max_pool(torch.relu(conv(s, x, 16, (5, 5), padding="VALID")),
                     (2, 2), (2, 2))
        x = torch.relu(dense(s, flatten_nchw(x), 120))
        x = torch.relu(dense(s, x, 84))
        return dense(s, x, self.output_dim)


@dataclass(frozen=True)
class CNNCifar:
    output_dim: int = 10

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        x = nhwc_to_nchw(x)
        x = max_pool(torch.relu(conv(s, x, 32, (3, 3))), (2, 2), (2, 2))
        x = max_pool(torch.relu(conv(s, x, 64, (3, 3))), (2, 2), (2, 2))
        x = torch.relu(conv(s, x, 64, (3, 3)))
        x = torch.relu(dense(s, flatten_nchw(x), 64))
        return dense(s, x, self.output_dim)
