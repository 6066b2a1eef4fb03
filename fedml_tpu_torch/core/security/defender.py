"""FedMLDefender — the robust-aggregation singleton of
``fedml_tpu/core/security/defender.py``, configured by
:meth:`FedMLDefender.init` (``enable_defense``, ``defense_type`` and the
defense's own arguments) and cleared by :meth:`reset`.

Two kinds of defense ride the dequant-fused compressed path and need no
decoded client trees (``compression.requires_full_trees`` is false for
them): the norm-only one (``norm_diff_clipping``: per-client clip factors
read off the compressed blocks, folded into the weights,
:meth:`fused_clip_factors`) and the fused robust statistics (trimmed mean,
coordinate-wise median: ``integrity.fused_robust_sum``). Every other
defense sees the decoded client models through the three ``defend_*``
hooks, in full FP32 on the card.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, List, Optional, Tuple

from fedml_tpu_torch.ml.trainer.local_sgd import fp32_precision
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.tree import Tree, tree_leaves

logger = logging.getLogger(__name__)


def _device_of(tree: Tree):
    return tree_leaves(tree)[0].device


class FedMLDefender:
    _instance = None

    def __init__(self):
        self.is_enabled = False
        self.defense_type: Optional[str] = None
        self.defender = None

    @classmethod
    def get_instance(cls) -> "FedMLDefender":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    def init(self, args: Any) -> None:
        self.is_enabled = bool(getattr(args, "enable_defense", False))
        if not self.is_enabled:
            return
        self.defense_type = str(getattr(args, "defense_type", "")).strip().lower()
        from fedml_tpu_torch.core.security.defense import create_defender

        self.defender = create_defender(self.defense_type, args)
        logger.info("defense enabled: %s", self.defense_type)

    def is_defense_enabled(self) -> bool:
        return self.is_enabled

    def is_norm_only_defense(self) -> bool:
        """The active defense needs only per-client update norms."""
        return self.is_enabled and self.defense_type == "norm_diff_clipping"

    def norm_clip_bound(self) -> float:
        return float(getattr(self.defender, "norm_bound", 0.0))

    def is_fused_defense(self) -> bool:
        """The active defense is a coordinate-wise robust statistic the
        integrity layer computes on the stacked compressed deltas."""
        return self.is_enabled and self.defense_type in (
            "trimmed_mean", "coordinate_wise_median")

    def fused_agg_spec(self) -> Optional[str]:
        """The active fused defense as an ``agg_robust`` spec, or None."""
        if not self.is_fused_defense():
            return None
        if self.defense_type == "coordinate_wise_median":
            return "median"
        return f"trimmed_mean@{float(getattr(self.defender, 'beta', 0.1)):g}"

    def fused_clip_factors(self, cts) -> Optional[List[float]]:
        """Per-client ``min(1, bound/‖d_i‖)`` for the fused path, the delta
        norms read off the compressed blocks (``telemetry.health.
        update_norm``); None without a norm-only defense. Counts the clipped
        clients in ``health/norm_clips_fused``."""
        if not self.is_norm_only_defense():
            return None
        from fedml_tpu_torch.telemetry.health import update_norm

        bound = self.norm_clip_bound()
        factors = []
        for ct in cts:
            norm = update_norm(ct)
            if norm is None:
                raise ValueError(
                    f"norm-only defense cannot norm a {ct.codec!r} update (masked "
                    "uploads hide their norms); it would go unclipped")
            factors.append(min(1.0, bound / (norm + 1e-12)))
        get_registry().counter("health/norm_clips_fused").inc(
            sum(1 for f in factors if f < 1.0))
        return factors

    def defend_before_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                                  extra_auxiliary_info: Any = None
                                  ) -> List[Tuple[int, Tree]]:
        with fp32_precision(_device_of(raw_client_grad_list[0][1])):
            return self.defender.defend_before_aggregation(raw_client_grad_list,
                                                           extra_auxiliary_info)

    def defend_on_aggregation(self, raw_client_grad_list: List[Tuple[int, Tree]],
                              base_aggregation_func: Callable = None,
                              extra_auxiliary_info: Any = None) -> Tree:
        with fp32_precision(_device_of(raw_client_grad_list[0][1])):
            return self.defender.defend_on_aggregation(
                raw_client_grad_list, base_aggregation_func, extra_auxiliary_info)

    def defend_after_aggregation(self, global_model: Tree) -> Tree:
        with fp32_precision(_device_of(global_model)):
            return self.defender.defend_after_aggregation(global_model)
