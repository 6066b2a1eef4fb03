"""Residual-based reweighting (Fu et al.): per-client IRLS weights from
per-coordinate median/MAD residuals — counterpart of
``fedml_tpu/core/security/defense/residual_reweight.py``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import (
    BaseDefense,
    median0,
    stack_updates,
    tree_unflatten_vector,
)
from fedml_tpu_torch.utils.tree import Tree


@register("residual_based_reweighting")
@register("residual_reweight")
class ResidualReweightDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.lmbda = float(getattr(args, "residual_lambda", 2.0))

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        vecs, _, template = stack_updates(raw_client_grad_list)
        med = median0(vecs)
        mad = median0(torch.abs(vecs - med[None, :])) * 1.4826 + 1e-12
        std_res = torch.abs(vecs - med[None, :]) / mad[None, :]
        # per-coordinate confidence, averaged per client: the IRLS weight
        wv = torch.mean(torch.clamp(1.0 - std_res / self.lmbda, 0.0, 1.0), dim=1)
        wv = wv / (torch.sum(wv) + 1e-12)
        return tree_unflatten_vector(torch.einsum("n,nd->d", wv, vecs), template)
