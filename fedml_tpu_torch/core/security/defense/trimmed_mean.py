"""Coordinate-wise trimmed mean (Yin et al., ICML'18): ``beta`` of the
cohort trimmed per side, the rest averaged — counterpart of
``fedml_tpu/core/security/defense/trimmed_mean.py``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense
from fedml_tpu_torch.utils.tree import Tree, tree_map, tree_stack


def trimmed_mean_tree(stacked: Tree, k: int) -> Tree:
    def _tm(x):
        xs = torch.sort(x, dim=0).values
        return torch.mean(xs[k:x.shape[0] - k], dim=0).to(x.dtype)

    return tree_map(_tm, stacked)


@register("trimmed_mean")
class TrimmedMeanDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.beta = float(getattr(args, "beta", 0.1))  # trim fraction per side

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        from fedml_tpu_torch.core.security.defense.blockwise import (
            should_go_blockwise,
            trimmed_mean_blockwise,
        )

        n = len(raw_client_grad_list)
        k = min(int(self.beta * n), (n - 1) // 2)
        trees = [p for _, p in raw_client_grad_list]
        if should_go_blockwise(raw_client_grad_list, self.args):
            return trimmed_mean_blockwise(trees, k)
        return trimmed_mean_tree(tree_stack(trees), k)
