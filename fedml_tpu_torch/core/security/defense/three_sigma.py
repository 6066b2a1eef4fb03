"""Three-sigma outlier rejection over a per-client score — counterpart of
``fedml_tpu/core/security/defense/three_sigma.py``: the distance to the
geometric median (``geomedian``), to the coordinate mean (``mean``), or
the largest cosine similarity to another client (``foolsgold``); clients
past ``mean + k_sigma·std`` are dropped."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense, stack_updates
from fedml_tpu_torch.core.security.defense.geometric_median import geometric_median
from fedml_tpu_torch.utils.tree import Tree


@register("3sigma")
@register("three_sigma")
class ThreeSigmaDefense(BaseDefense):
    score_override = None

    def __init__(self, args: Any):
        super().__init__(args)
        self.score = (self.score_override
                      or str(getattr(args, "three_sigma_score", "geomedian"))).lower()
        self.k_sigma = float(getattr(args, "k_sigma", 3.0))

    def _scores(self, vecs: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
        if self.score == "foolsgold":
            # sybils are suspiciously ALIGNED: their max cosine nears 1
            normed = vecs / (torch.linalg.vector_norm(vecs, dim=1, keepdim=True) + 1e-12)
            cs = normed @ normed.T - torch.eye(vecs.shape[0], device=vecs.device)
            return torch.max(cs, dim=1).values
        if self.score == "geomedian":
            center = geometric_median(vecs, counts)
        else:
            center = torch.mean(vecs, dim=0)
        return torch.linalg.vector_norm(vecs - center[None, :], dim=1)

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        vecs, counts, _ = stack_updates(raw_client_grad_list)
        scores = self._scores(vecs, counts)
        mu = torch.mean(scores)
        sigma = torch.std(scores, correction=0) + 1e-12
        keep = (scores <= mu + self.k_sigma * sigma).cpu().tolist()
        kept = [p for p, k in zip(raw_client_grad_list, keep) if k]
        return kept if kept else raw_client_grad_list


@register("three_sigma_geomedian")
class ThreeSigmaGeoMedianDefense(ThreeSigmaDefense):
    score_override = "geomedian"


@register("three_sigma_foolsgold")
class ThreeSigmaFoolsGoldDefense(ThreeSigmaDefense):
    score_override = "foolsgold"
