"""Outlier detection on update norms and the cosine to the previous
round's mean update — counterpart of
``fedml_tpu/core/security/defense/outlier_detection.py`` (also registered
as ``cross_round``, as there)."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense, median0, stack_updates
from fedml_tpu_torch.utils.tree import Tree


@register("outlier_detection")
@register("cross_round")
class OutlierDetectionDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.threshold = float(getattr(args, "outlier_cos_threshold", -0.5))
        self._prev_mean = None

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        vecs, _, _ = stack_updates(raw_client_grad_list)
        mean = torch.mean(vecs, dim=0)
        has_prev = self._prev_mean is not None and self._prev_mean.shape == mean.shape
        ref = self._prev_mean if has_prev else mean
        self._prev_mean = mean
        norms = torch.linalg.vector_norm(vecs, dim=1)
        cos = (vecs @ ref) / (norms * (torch.linalg.vector_norm(ref) + 1e-12) + 1e-12)
        keep = (cos >= self.threshold) & (norms <= 5.0 * (median0(norms) + 1e-12))
        keep = keep.cpu().tolist()
        kept = [p for p, k in zip(raw_client_grad_list, keep) if k]
        return kept if kept else raw_client_grad_list
