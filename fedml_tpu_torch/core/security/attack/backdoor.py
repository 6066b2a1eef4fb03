"""Backdoor data poisoning — a copy of
``fedml_tpu/core/security/attack/backdoor.py``: a pixel trigger stamped on
a ``poisoned_ratio`` of the samples (numpy generator seeded
``random_seed + 23``), relabeled to ``backdoor_target_class``; and the
edge-case variant (Wang et al., NeurIPS'20), which pushes the samples
farthest from the data mean further out and relabels them."""
from __future__ import annotations

from typing import Any

import numpy as np

from fedml_tpu_torch.core.security.attack import register
from fedml_tpu_torch.core.security.attack.base import BaseAttack


@register("backdoor")
class BackdoorAttack(BaseAttack):
    is_data_attack = True

    def __init__(self, args: Any):
        super().__init__(args)
        self.target_class = int(getattr(args, "backdoor_target_class", 0))
        self.ratio = float(getattr(args, "poisoned_ratio", 0.2))
        self.trigger_value = float(getattr(args, "trigger_value", 1.0))
        self.trigger_size = int(getattr(args, "trigger_size", 3))
        self._rng = np.random.default_rng(int(getattr(args, "random_seed", 0)) + 23)

    def poison_data(self, dataset: Any) -> Any:
        x, y = np.array(dataset[0], copy=True), np.array(dataset[1], copy=True)
        n = len(y)
        idx = self._rng.choice(n, size=int(self.ratio * n), replace=False)
        t = self.trigger_size
        if x.ndim >= 3:  # an image batch [N, H, W, ...]: the corner patch
            x[idx, :t, :t, ...] = self.trigger_value
        else:  # flat features: the leading coordinates
            x[idx, :t] = self.trigger_value
        y[idx] = self.target_class
        return (x, y)


@register("edge_case_backdoor")
class EdgeCaseBackdoorAttack(BackdoorAttack):
    """Poison with the tail of the local distribution, relabeled."""

    def poison_data(self, dataset: Any) -> Any:
        x, y = np.array(dataset[0], copy=True), np.array(dataset[1], copy=True)
        n = len(y)
        n_poison = max(1, int(self.ratio * n))
        flat = x.reshape(n, -1).astype(np.float64)
        center = flat.mean(axis=0)
        dist = np.linalg.norm(flat - center[None], axis=1)
        tail = np.argsort(dist)[-n_poison:]
        x[tail] = x[tail] + (x[tail] - center.reshape(x.shape[1:]).astype(x.dtype))
        y[tail] = self.target_class
        return (x, y)
