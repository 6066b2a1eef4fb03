"""WBC: the updates split by a 1-D 2-means on their distance to the
coordinate median, the nearer cluster kept — counterpart of
``fedml_tpu/core/security/defense/wbc.py``."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense, median0, stack_updates
from fedml_tpu_torch.utils.tree import Tree


@register("wbc")
class WbcDefense(BaseDefense):
    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        vecs, _, _ = stack_updates(raw_client_grad_list)
        dists = torch.linalg.vector_norm(vecs - median0(vecs)[None, :], dim=1)
        zero = torch.zeros_like(dists)
        # threshold at the extremes' midpoint, then ten 2-means steps
        thresh = (torch.min(dists) + torch.max(dists)) / 2.0
        for _ in range(10):
            low = dists <= thresh
            lo_cnt = torch.sum(low)
            hi_cnt = torch.clamp_min(dists.shape[0] - lo_cnt, 1)
            hi_mean = torch.sum(torch.where(~low, dists, zero)) / hi_cnt
            lo_mean = torch.sum(torch.where(low, dists, zero)) / torch.clamp_min(lo_cnt, 1)
            new = (lo_mean + hi_mean) / 2.0
            thresh = torch.where(torch.isfinite(new), new, thresh)
        keep = (dists <= thresh).cpu().tolist()
        kept = [p for p, k in zip(raw_client_grad_list, keep) if k]
        return kept if kept else raw_client_grad_list
