"""SLSGD (Xie et al.): the trimmed mean (``trim_param_b`` per side) mixed
with the previous global by ``alpha`` — counterpart of
``fedml_tpu/core/security/defense/slsgd.py``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense
from fedml_tpu_torch.core.security.defense.trimmed_mean import trimmed_mean_tree
from fedml_tpu_torch.utils.tree import Tree, tree_map, tree_stack


@register("slsgd")
class SLSGDDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.b = int(getattr(args, "trim_param_b", 1))
        self.alpha = float(getattr(args, "alpha", 0.6))

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        n = len(raw_client_grad_list)
        k = min(self.b, (n - 1) // 2)
        agg = trimmed_mean_tree(tree_stack([p for _, p in raw_client_grad_list]), k)
        if extra_auxiliary_info is not None:
            # (1 - alpha) * old_global + alpha * aggregated
            a = self.alpha
            agg = tree_map(lambda g, x: (1.0 - a) * g + x * a, extra_auxiliary_info, agg)
        return agg
