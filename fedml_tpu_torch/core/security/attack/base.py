"""Attack base class — counterpart of ``fedml_tpu/core/security/attack/base.py``."""
from __future__ import annotations

from typing import Any, List, Tuple

from fedml_tpu_torch.utils.tree import Tree


class BaseAttack:
    is_data_attack = False
    is_model_attack = False
    is_reconstruct = False

    def __init__(self, args: Any):
        self.args = args

    def poison_data(self, dataset: Any) -> Any:
        return dataset

    def attack_model(self, raw_client_grad_list: List[Tuple[int, Tree]],
                     extra_auxiliary_info: Any = None) -> List[Tuple[int, Tree]]:
        return raw_client_grad_list

    def reconstruct_data(self, a_gradient: Any, extra_auxiliary_info: Any = None):
        raise NotImplementedError
