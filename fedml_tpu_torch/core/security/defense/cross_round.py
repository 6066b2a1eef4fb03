"""Cross-round consistency: a client whose update direction turns against
its own previous one (cosine below ``cross_round_sim_threshold``) is
dropped — counterpart of ``fedml_tpu/core/security/defense/cross_round.py``.
As in the reference, the name ``cross_round`` is taken over by
``outlier_detection``, which registers it later."""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense, stack_updates
from fedml_tpu_torch.utils.tree import Tree


@register("cross_round")
class CrossRoundDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.sim_threshold = float(getattr(args, "cross_round_sim_threshold", -0.2))
        self._history: Dict[int, torch.Tensor] = {}

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        vecs, _, _ = stack_updates(raw_client_grad_list)
        keep = []
        for i in range(vecs.shape[0]):
            prev = self._history.get(i)
            ok = True
            if prev is not None:
                denom = torch.linalg.vector_norm(prev) * torch.linalg.vector_norm(vecs[i]) + 1e-12
                ok = float(prev @ vecs[i]) / float(denom) >= self.sim_threshold
            self._history[i] = vecs[i]
            if ok:
                keep.append(i)
        if not keep:  # never reject the whole round
            keep = list(range(vecs.shape[0]))
        return [raw_client_grad_list[i] for i in keep]
