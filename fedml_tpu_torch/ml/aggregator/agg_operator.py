"""FedMLAggOperator — counterpart of
``fedml_tpu/ml/aggregator/agg_operator.py``: client trees stacked on a
leading axis and reduced by one weighted sum, with the reference's
weighting (sample counts for the FedAvg family, uniform for SCAFFOLD and
Mime), and the dequant-fused aggregation of compressed client deltas.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from fedml_tpu_torch.utils.tree import Tree, tree_stack, weighted_tree_sum

_UNIFORM_OPTS = {"SCAFFOLD", "Mime"}


class FedMLAggOperator:
    @staticmethod
    def agg(args: Any, raw_grad_list: List[Tuple[int, Tree]]) -> Tree:
        """Aggregate ``[(n_samples, params), ...]`` → params."""
        if len(raw_grad_list) == 0:
            raise ValueError("empty client model list")
        weights = FedMLAggOperator._weights(args, raw_grad_list)
        return weighted_tree_sum(tree_stack([p for _, p in raw_grad_list]), weights)

    @staticmethod
    def agg_with_weights(raw_list: List[Tree], weights: List[float]) -> Tree:
        w = torch.as_tensor(weights, dtype=torch.float32)
        return weighted_tree_sum(tree_stack(raw_list), w / torch.sum(w))

    @staticmethod
    def _weights(args: Any, raw_list: List[Tuple[int, Any]]) -> torch.Tensor:
        """The weighting rule of :meth:`agg`, as a float32 vector."""
        opt = getattr(args, "federated_optimizer", "FedAvg")
        n = len(raw_list)
        if opt in _UNIFORM_OPTS:
            return torch.full((n,), 1.0 / n, dtype=torch.float32)
        counts = torch.as_tensor([float(num) for num, _ in raw_list],
                                 dtype=torch.float32)
        return counts / torch.sum(counts)

    @staticmethod
    def agg_compressed(args: Any, raw_list: List[Tuple[int, Any]],
                       global_params: Tree, clip_factors: Any = None,
                       agg_robust: Any = None) -> Tree:
        """Dequant-fused aggregation of compressed client updates:
        ``raw_list`` is ``[(n_samples, CompressedTree), ...]``, each the
        client's delta against ``global_params``; since the weights are
        normalized, x̄ = g + Σ pᵢdᵢ, so only the aggregate is ever built.
        Norm-clip factors and robust statistics are the trust stack's
        (ROADMAP A10) and raise."""
        from fedml_tpu_torch.compression import (
            CompressedTree,
            fused_weighted_sum,
            tree_undelta,
        )

        if clip_factors is not None or agg_robust:
            raise NotImplementedError(
                "norm-clip factors and robust aggregation (agg_robust) come with "
                "the trust stack, ROADMAP A10")
        if len(raw_list) == 0:
            raise ValueError("empty client model list")
        cts = [ct for _, ct in raw_list]
        if not all(isinstance(ct, CompressedTree) for ct in cts):
            raise ValueError("agg_compressed requires CompressedTree updates")
        if not all(ct.is_delta for ct in cts):
            raise ValueError("agg_compressed requires delta-encoded updates")
        weights = FedMLAggOperator._weights(args, raw_list)
        return tree_undelta(global_params, fused_weighted_sum(cts, weights))
