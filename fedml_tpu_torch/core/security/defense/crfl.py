"""CRFL (Xie et al., ICML'21): the aggregate clipped to
``crfl_clip_threshold`` and smoothed with gaussian noise of ``crfl_sigma``
each round, under ``fold_in(key(random_seed + 15485863), round count)`` —
counterpart of ``fedml_tpu/core/security/defense/crfl.py``."""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.core.dp.frames.dp_clip import clip_update
from fedml_tpu_torch.core.dp.mechanisms import add_gaussian_noise
from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense
from fedml_tpu_torch.utils.tree import Tree


@register("crfl")
class CRFLDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.clip_threshold = float(getattr(args, "crfl_clip_threshold", 15.0))
        self.sigma = float(getattr(args, "crfl_sigma", 0.01))
        self._counter = 0
        self._seed = int(getattr(args, "random_seed", 0)) + 15485863

    def defend_after_aggregation(self, global_model: Tree) -> Tree:
        self._counter += 1
        clipped = clip_update(global_model, self.clip_threshold)
        key = threefry.fold_in(threefry.key(self._seed), self._counter)
        return add_gaussian_noise(clipped, key, self.sigma)
