"""Bulyan (El Mhamdi et al., ICML'18): Multi-Krum selection, then per
coordinate the mean of the values closest to the median — counterpart of
``fedml_tpu/core/security/defense/bulyan.py``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import (
    BaseDefense,
    median0,
    pairwise_sq_dists,
    stack_updates,
    tree_unflatten_vector,
)
from fedml_tpu_torch.utils.tree import Tree


@register("bulyan")
class BulyanDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.byzantine_client_num = int(getattr(args, "byzantine_client_num", 1))

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        n = len(raw_client_grad_list)
        f = min(self.byzantine_client_num, max(0, (n - 3) // 4))
        theta = max(1, n - 2 * f)  # the selection set's size
        beta = max(1, theta - 2 * f)  # values kept per coordinate
        vecs, _, template = stack_updates(raw_client_grad_list)
        d = pairwise_sq_dists(vecs)
        d.fill_diagonal_(float("inf"))
        m = max(1, n - f - 2)
        scores = torch.sum(torch.sort(d, dim=1).values[:, :m], dim=1)
        selected = vecs[torch.argsort(scores, stable=True)[:theta]]
        med = median0(selected)
        dist = torch.abs(selected - med[None, :])
        order = torch.argsort(dist, dim=0, stable=True)[:beta]
        kept = torch.gather(selected, 0, order)
        return tree_unflatten_vector(torch.mean(kept, dim=0), template)
