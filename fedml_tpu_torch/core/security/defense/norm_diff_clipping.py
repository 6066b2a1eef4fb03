"""Norm-difference clipping (Sun et al., "Can you really backdoor FL?"):
each update's difference from a center clipped to ``norm_bound`` —
counterpart of ``fedml_tpu/core/security/defense/norm_diff_clipping.py``.
On the compressed path the clip folds into the aggregation weight instead
(``FedMLDefender.fused_clip_factors``)."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import (
    BaseDefense,
    stack_updates,
    tree_flatten_vector,
    unstack_to_list,
)
from fedml_tpu_torch.utils.tree import Tree


def clip_rows_to(vecs: torch.Tensor, center: torch.Tensor, bound: float) -> torch.Tensor:
    """Each row's difference from ``center`` clipped to L2 norm ``bound``."""
    diffs = vecs - center[None, :]
    norms = torch.linalg.vector_norm(diffs, dim=1, keepdim=True)
    factor = torch.clamp_max(torch.tensor(bound, dtype=torch.float32,
                                          device=vecs.device) / (norms + 1e-12), 1.0)
    return center[None, :] + diffs * factor


@register("norm_diff_clipping")
class NormDiffClippingDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.norm_bound = float(getattr(args, "norm_bound", 5.0))

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        vecs, counts, template = stack_updates(raw_client_grad_list)
        if extra_auxiliary_info is not None and not isinstance(extra_auxiliary_info, dict):
            center = tree_flatten_vector(extra_auxiliary_info)
        else:
            center = torch.zeros(vecs.shape[1], dtype=vecs.dtype, device=vecs.device)
        return unstack_to_list(clip_rows_to(vecs, center, self.norm_bound), counts,
                               template)
