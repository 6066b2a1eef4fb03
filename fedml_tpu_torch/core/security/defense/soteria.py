"""Soteria (Sun et al., CVPR'21): the representation layer of each update
(its largest leaf) pruned below its ``soteria_percentile`` magnitude —
counterpart of ``fedml_tpu/core/security/defense/soteria.py``."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense
from fedml_tpu_torch.utils.tree import Tree, tree_flatten


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` (linear interpolation) over all elements."""
    s = torch.sort(x.reshape(-1).float()).values
    pos = torch.tensor(q / 100.0, dtype=torch.float32) * (s.numel() - 1)
    lo = int(torch.floor(pos))
    hi = min(lo + 1, s.numel() - 1)
    w = float(pos - lo)
    return s[lo] * (1.0 - w) + s[hi] * w


@register("soteria")
class SoteriaDefense(BaseDefense):
    def __init__(self, args: Any):
        super().__init__(args)
        self.percentile = float(getattr(args, "soteria_percentile", 10.0))

    def _perturb_largest_leaf(self, tree: Tree) -> Tree:
        leaves, keys = tree_flatten(tree)
        target = max(range(len(leaves)), key=lambda i: (leaves[i].numel(), -i))
        out = dict(tree)
        leaf = leaves[target]
        thresh = percentile(torch.abs(leaf), self.percentile)
        out[keys[target]] = torch.where(torch.abs(leaf) < thresh,
                                        torch.zeros_like(leaf), leaf)
        return {k: out[k] for k in keys}

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        return [(n, self._perturb_largest_leaf(p)) for n, p in raw_client_grad_list]
