"""Lazy-worker attack — counterpart of
``fedml_tpu/core/security/attack/lazy_worker.py``: the first
``lazy_worker_num`` clients upload the global model they received, with
gaussian camouflage noise (``lazy_camouflage_std``) from a numpy generator
seeded ``random_seed + 41``, drawn in the reference's layout of each leaf."""
from __future__ import annotations

from typing import Any, List, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.alg_frame.params import Context
from fedml_tpu_torch.core.security.attack import register
from fedml_tpu_torch.core.security.attack.base import BaseAttack
from fedml_tpu_torch.models.convert import _from_ref, _to_ref
from fedml_tpu_torch.utils.tree import Tree, tree_flatten


@register("lazy_worker")
class LazyWorkerAttack(BaseAttack):
    is_model_attack = True

    def __init__(self, args: Any):
        super().__init__(args)
        self.n_lazy = int(getattr(args, "lazy_worker_num", 1))
        self.camouflage_std = float(getattr(args, "lazy_camouflage_std", 1e-3))
        self._rng = np.random.default_rng(int(getattr(args, "random_seed", 0)) + 41)

    def _camouflaged(self, base: Tree) -> Tree:
        leaves, keys = tree_flatten(base)
        out = {}
        for path, x in zip(keys, leaves):
            if not x.is_floating_point():
                out[path] = x
                continue
            ref = _to_ref(path, x)
            noise = self._rng.normal(0.0, self.camouflage_std, tuple(ref.shape))
            noise = torch.from_numpy(noise.astype(np.float32)).to(x.device).to(x.dtype)
            out[path] = _from_ref(path, ref + noise).contiguous()
        return out

    def attack_model(self, raw_client_grad_list: List[Tuple[int, Tree]],
                     extra_auxiliary_info: Any = None) -> List[Tuple[int, Tree]]:
        base = extra_auxiliary_info
        if base is None:
            base = Context().get("global_model_for_defense")
        if base is None:  # nothing to free-ride on
            return raw_client_grad_list
        out = list(raw_client_grad_list)
        for i in range(min(self.n_lazy, len(out))):
            out[i] = (out[i][0], self._camouflaged(base))
        return out
