"""Label-flipping data poisoning — a copy of
``fedml_tpu/core/security/attack/label_flipping.py``: labels flipped from
``original_class_list`` to ``target_class_list`` (or each shifted by one
class) on a ``poisoned_ratio`` of the attacker's ``(x, y)`` arrays, drawn
from a numpy generator seeded ``random_seed + 17``."""
from __future__ import annotations

from typing import Any

import numpy as np

from fedml_tpu_torch.core.security.attack import register
from fedml_tpu_torch.core.security.attack.base import BaseAttack


@register("label_flipping")
class LabelFlippingAttack(BaseAttack):
    is_data_attack = True

    def __init__(self, args: Any):
        super().__init__(args)
        self.original_class = getattr(args, "original_class_list", None)
        self.target_class = getattr(args, "target_class_list", None)
        self.ratio = float(getattr(args, "poisoned_ratio", 1.0))
        self._rng = np.random.default_rng(int(getattr(args, "random_seed", 0)) + 17)

    def poison_data(self, dataset: Any) -> Any:
        x, y = dataset[0], np.array(dataset[1])
        n = len(y)
        idx = self._rng.choice(n, size=int(self.ratio * n), replace=False)
        if self.original_class is not None and self.target_class is not None:
            for o, t in zip(np.atleast_1d(self.original_class),
                            np.atleast_1d(self.target_class)):
                mask = np.isin(idx, np.where(y == o)[0])
                y[idx[mask]] = t
        else:
            num_classes = int(y.max()) + 1 if n else 0
            y[idx] = (y[idx] + 1) % max(1, num_classes)
        return (x, y)
