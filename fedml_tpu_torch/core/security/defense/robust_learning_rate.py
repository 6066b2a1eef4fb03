"""Robust learning rate (Ozdayi et al., AAAI'21): the server step's sign
flips on coordinates whose update signs agree less than
``robust_threshold`` — counterpart of
``fedml_tpu/core/security/defense/robust_learning_rate.py``."""
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


@register("robust_learning_rate")
class RobustLearningRateDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.robust_threshold = float(getattr(args, "robust_threshold", 4.0))

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        vecs, counts, template = stack_updates(raw_client_grad_list)
        agg = torch.einsum("n,nd->d", counts / torch.sum(counts), vecs)
        agreement = torch.abs(torch.sum(torch.sign(vecs), dim=0))
        lr_sign = torch.where(agreement >= self.robust_threshold, 1.0, -1.0)
        return tree_unflatten_vector(lr_sign * agg, template)
