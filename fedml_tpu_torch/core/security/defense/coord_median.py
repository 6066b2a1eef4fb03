"""Coordinate-wise median (Yin et al., ICML'18) — counterpart of
``fedml_tpu/core/security/defense/coord_median.py``: the mean of the two
middle values for an even cohort, as ``jnp.median``."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

from fedml_tpu_torch.core.security.defense import register
from fedml_tpu_torch.core.security.defense.base import BaseDefense, median0
from fedml_tpu_torch.utils.tree import Tree, tree_map, tree_stack


@register("coordinate_wise_median")
class CoordinateWiseMedianDefense(BaseDefense):
    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        from fedml_tpu_torch.core.security.defense.blockwise import (
            coordinate_median_blockwise,
            should_go_blockwise,
        )

        trees = [p for _, p in raw_client_grad_list]
        if should_go_blockwise(raw_client_grad_list, self.args):
            return coordinate_median_blockwise(trees)
        return tree_map(lambda x: median0(x).to(x.dtype), tree_stack(trees))
