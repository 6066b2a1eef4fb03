"""RFA / geometric median by smoothed Weiszfeld (Pillutla et al., 2022) —
counterpart of ``fedml_tpu/core/security/defense/geometric_median.py``.
On the card, and past the stack budget, it streams block by block."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import (
    BaseDefense,
    stack_updates,
    tree_unflatten_vector,
)
from fedml_tpu_torch.utils.tree import Tree


def geometric_median(vecs: torch.Tensor, weights: torch.Tensor, iters: int = 10,
                     eps: float = 1e-8) -> torch.Tensor:
    w = weights / torch.sum(weights)
    z = torch.einsum("n,nd->d", w, vecs)
    for _ in range(int(iters)):
        dists = torch.sqrt(torch.sum((vecs - z[None, :]) ** 2, dim=1) + eps)
        alpha = w / dists
        z = torch.einsum("n,nd->d", alpha / torch.sum(alpha), vecs)
    return z


@register("rfa")
@register("geometric_median")
class GeometricMedianDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.iters = int(getattr(args, "geo_median_iters", 10))

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        from fedml_tpu_torch.core.security.defense.blockwise import (
            geometric_median_blockwise,
            on_card,
            should_go_blockwise,
        )

        if should_go_blockwise(raw_client_grad_list, self.args) or on_card(
                raw_client_grad_list):
            return geometric_median_blockwise(
                [p for _, p in raw_client_grad_list],
                [n for n, _ in raw_client_grad_list], iters=self.iters)
        vecs, counts, template = stack_updates(raw_client_grad_list)
        return tree_unflatten_vector(geometric_median(vecs, counts, self.iters), template)
