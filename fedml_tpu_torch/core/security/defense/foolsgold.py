"""FoolsGold (Fung et al.): sybils down-weighted by the cosine similarity
of their update histories — counterpart of
``fedml_tpu/core/security/defense/foolsgold.py``."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import (
    BaseDefense,
    stack_updates,
    tree_unflatten_vector,
)
from fedml_tpu_torch.utils.tree import Tree


@register("foolsgold")
class FoolsGoldDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.use_memory = bool(getattr(args, "foolsgold_use_memory", True))
        self._history: Dict[int, torch.Tensor] = {}

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        vecs, _, template = stack_updates(raw_client_grad_list)
        n = vecs.shape[0]
        if self.use_memory:
            for i in range(n):
                prev = self._history.get(i)
                self._history[i] = vecs[i] if prev is None else prev + vecs[i]
            hist = torch.stack([self._history[i] for i in range(n)])
        else:
            hist = vecs
        normed = hist / (torch.linalg.vector_norm(hist, dim=1, keepdim=True) + 1e-12)
        cs = normed @ normed.T - torch.eye(n, device=vecs.device)
        maxcs = torch.max(cs, dim=1).values
        # pardoning: rescale the similarity by the relative maxima
        ratio = maxcs[None, :] / (maxcs[:, None] + 1e-12)
        cs = torch.where(maxcs[:, None] < maxcs[None, :], cs * ratio, cs)
        wv = torch.clamp(1.0 - torch.max(cs, dim=1).values, 0.0, 1.0)
        wv = wv / (torch.max(wv) + 1e-12)
        # the paper's logit rescaling
        safe = torch.clamp(wv, 1e-6, 1.0 - 1e-6)
        wv = torch.where(wv == 1.0, torch.ones_like(wv),
                         torch.clamp(torch.log(safe / (1.0 - safe)) / 4.0 + 0.5, 0.0, 1.0))
        agg = torch.einsum("n,nd->d", wv / (torch.sum(wv) + 1e-12), vecs)
        return tree_unflatten_vector(agg, template)
