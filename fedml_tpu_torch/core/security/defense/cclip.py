"""Centered clipping (Karimireddy et al.): updates clipped to ``cclip_tau``
around a momentum center kept across rounds, then averaged — counterpart
of ``fedml_tpu/core/security/defense/cclip.py``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import (
    BaseDefense,
    stack_updates,
    tree_unflatten_vector,
)
from fedml_tpu_torch.core.security.defense.norm_diff_clipping import clip_rows_to
from fedml_tpu_torch.utils.tree import Tree


@register("cclip")
class CClipDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.tau = float(getattr(args, "cclip_tau", 10.0))
        self.iters = int(getattr(args, "cclip_iters", 1))
        self._center = None

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        vecs, counts, template = stack_updates(raw_client_grad_list)
        center = (self._center if self._center is not None
                  and self._center.shape == (vecs.shape[1],)
                  else torch.zeros(vecs.shape[1], dtype=vecs.dtype, device=vecs.device))
        w = counts / torch.sum(counts)
        for _ in range(self.iters):
            center = torch.einsum("n,nd->d", w, clip_rows_to(vecs, center, self.tau))
        self._center = center
        return tree_unflatten_vector(center, template)
