"""Weak DP: small gaussian noise (``stddev``) on the aggregate, under
``fold_in(key(random_seed + 104729), round count)`` — counterpart of
``fedml_tpu/core/security/defense/weak_dp.py``."""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.core.dp.mechanisms import add_gaussian_noise
from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense
from fedml_tpu_torch.utils.tree import Tree


@register("weak_dp")
class WeakDPDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.stddev = float(getattr(args, "stddev", 0.002))
        self._counter = 0
        self._seed = int(getattr(args, "random_seed", 0)) + 104729

    def defend_after_aggregation(self, global_model: Tree) -> Tree:
        self._counter += 1
        key = threefry.fold_in(threefry.key(self._seed), self._counter)
        return add_gaussian_noise(global_model, key, self.stddev)
