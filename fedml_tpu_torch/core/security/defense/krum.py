"""Krum / Multi-Krum (Blanchard et al., NeurIPS'17) — counterpart of
``fedml_tpu/core/security/defense/krum.py``: pairwise distances through
one gram product, or the gram accumulated block by block
(:mod:`.blockwise`) on the card and past the stack budget."""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import (
    BaseDefense,
    pairwise_sq_dists,
    stack_updates,
)
from fedml_tpu_torch.utils.tree import Tree


def select_krum(d, f: int, k: int) -> List[int]:
    """Keep the ``k`` clients whose summed ``n-f-2`` nearest squared
    distances are smallest (ties to the lower index); sorted indices."""
    d = torch.as_tensor(np.asarray(d) if not isinstance(d, torch.Tensor) else d).clone()
    n = d.shape[0]
    m = max(1, n - f - 2)
    d.fill_diagonal_(float("inf"))
    scores = torch.sum(torch.sort(d, dim=1).values[:, :m], dim=1)
    keep = torch.argsort(scores, stable=True)[:k]
    return sorted(int(i) for i in keep.cpu().tolist())


@register("krum")
class KrumDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.byzantine_client_num = int(getattr(args, "byzantine_client_num", 1))
        # multi-krum keeps k survivors; plain krum keeps 1
        self.krum_param_k = int(getattr(args, "krum_param_k", 1))
        if bool(getattr(args, "multi", False)):
            self.krum_param_k = max(self.krum_param_k, 2)

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        from fedml_tpu_torch.core.security.defense.blockwise import (
            flatten_clients,
            iter_blocks,
            on_card,
            pairwise_sq_dists_blockwise,
            should_go_blockwise,
        )

        n = len(raw_client_grad_list)
        f = min(self.byzantine_client_num, max(0, (n - 3) // 2))
        if should_go_blockwise(raw_client_grad_list, self.args) or on_card(
                raw_client_grad_list):
            d = pairwise_sq_dists_blockwise(iter_blocks(flatten_clients(
                [p for _, p in raw_client_grad_list])), n)
        else:
            d = pairwise_sq_dists(stack_updates(raw_client_grad_list)[0])
        return [raw_client_grad_list[i] for i in select_krum(d, f, self.krum_param_k)]
