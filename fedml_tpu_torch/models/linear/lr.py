"""Logistic regression and an MLP — counterparts of
``fedml_tpu/models/linear/lr.py`` (BASELINE config #1: LR on MNIST)."""
from __future__ import annotations

from dataclasses import dataclass

import torch

from fedml_tpu_torch.models.layers import Scope, dense


@dataclass(frozen=True)
class LogisticRegression:
    output_dim: int

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        return dense(s, x.reshape(x.shape[0], -1), self.output_dim)


@dataclass(frozen=True)
class MLP:
    hidden_dim: int
    output_dim: int

    def __call__(self, s: Scope, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(dense(s, x.reshape(x.shape[0], -1), self.hidden_dim))
        return dense(s, x, self.output_dim)
