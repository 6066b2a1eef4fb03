"""Byzantine attack: the first ``byzantine_client_num`` updates replaced by
zeros, sign-flipped values or random noise — counterpart of
``fedml_tpu/core/security/attack/byzantine.py``. The random mode draws
``normal`` under ``fold_in(key(random_seed + 31337), c)`` for the ``c``-th
replaced update, split per leaf, in the reference's layout."""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.core.dp.mechanisms import noise_tree
from fedml_tpu_torch.core.security.attack import register
from fedml_tpu_torch.core.security.attack.base import BaseAttack
from fedml_tpu_torch.utils.tree import Tree, tree_map, tree_scale


@register("byzantine")
class ByzantineAttack(BaseAttack):
    is_model_attack = True

    def __init__(self, args: Any):
        super().__init__(args)
        self.byzantine_client_num = int(getattr(args, "byzantine_client_num", 1))
        self.attack_mode = str(getattr(args, "attack_mode", "random")).lower()
        self._seed = int(getattr(args, "random_seed", 0)) + 31337
        self._counter = 0

    def attack_model(self, raw_client_grad_list: List[Tuple[int, Tree]],
                     extra_auxiliary_info: Any = None) -> List[Tuple[int, Tree]]:
        k = min(self.byzantine_client_num, len(raw_client_grad_list))
        out = list(raw_client_grad_list)
        for i in range(k):
            n, params = out[i]
            if self.attack_mode == "zero":
                evil = tree_scale(params, 0.0)
            elif self.attack_mode == "flip":
                evil = tree_scale(params, -1.0)
            else:  # random
                self._counter += 1
                key = threefry.fold_in(threefry.key(self._seed), self._counter)
                evil = noise_tree(tree_map(torch.zeros_like, params), key,
                                  threefry.normal, 1.0)
            out[i] = (n, evil)
        return out
