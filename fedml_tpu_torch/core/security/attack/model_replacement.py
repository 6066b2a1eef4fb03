"""Model-replacement (scaled backdoor) attack, Bagdasaryan et al. —
counterpart of ``fedml_tpu/core/security/attack/model_replacement.py``:
the first update is boosted by ``replacement_scale`` (0: the cohort size)
so it survives averaging."""
from __future__ import annotations

from typing import Any, List, Tuple

from fedml_tpu_torch.core.security.attack import register
from fedml_tpu_torch.core.security.attack.base import BaseAttack
from fedml_tpu_torch.utils.tree import Tree, tree_map, tree_sub


@register("model_replacement")
class ModelReplacementAttack(BaseAttack):
    is_model_attack = True

    def __init__(self, args: Any):
        super().__init__(args)
        self.scale = float(getattr(args, "replacement_scale", 0.0))  # 0 → auto N

    def attack_model(self, raw_client_grad_list: List[Tuple[int, Tree]],
                     extra_auxiliary_info: Any = None) -> List[Tuple[int, Tree]]:
        if not raw_client_grad_list:
            return raw_client_grad_list
        gamma = self.scale or float(len(raw_client_grad_list))
        n, params = raw_client_grad_list[0]
        if extra_auxiliary_info is not None:
            # global + gamma * (params - global)
            delta = tree_sub(params, extra_auxiliary_info)
            boosted = tree_map(lambda d, g: gamma * d + g, delta, extra_auxiliary_info)
        else:
            boosted = tree_map(lambda p: (gamma - 1.0) * p + p, params)
        out = list(raw_client_grad_list)
        out[0] = (n, boosted)
        return out
