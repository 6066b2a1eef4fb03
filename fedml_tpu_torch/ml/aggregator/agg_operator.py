"""FedMLAggOperator — counterpart of
``fedml_tpu/ml/aggregator/agg_operator.py``: client trees stacked on a
leading axis and reduced by one weighted sum, one leaf at a time (the
reference stacks whole trees; the bits are the same), with the reference's
weighting (sample counts for the FedAvg family, uniform for SCAFFOLD and
Mime), and the dequant-fused aggregation of compressed client deltas.
"""
from __future__ import annotations

from typing import Any, List, Tuple

import torch

from fedml_tpu_torch.utils.tree import Tree, weighted_sum_of_trees

_UNIFORM_OPTS = {"SCAFFOLD", "Mime"}


class FedMLAggOperator:
    @staticmethod
    def agg(args: Any, raw_grad_list: List[Tuple[int, Tree]]) -> Tree:
        """Aggregate ``[(n_samples, params), ...]`` → params."""
        if len(raw_grad_list) == 0:
            raise ValueError("empty client model list")
        weights = FedMLAggOperator._weights(args, raw_grad_list)
        return weighted_sum_of_trees([p for _, p in raw_grad_list], weights)

    @staticmethod
    def agg_with_weights(raw_list: List[Tree], weights: List[float]) -> Tree:
        w = torch.as_tensor(weights, dtype=torch.float32)
        return weighted_sum_of_trees(raw_list, w / torch.sum(w))

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

        ``clip_factors`` (a norm-only defense's ``min(1, bound/‖dᵢ‖)``)
        multiply the weights without renormalizing: clipping shrinks
        updates, it does not redistribute their mass. ``agg_robust`` (a
        spec like ``trimmed_mean@0.1``) swaps the weighted mean for the
        unweighted coordinate-wise robust statistic of the deltas
        (``integrity.fused_robust_sum``); the two together raise."""
        from fedml_tpu_torch.compression import (
            CompressedTree,
            fused_weighted_sum,
            tree_undelta,
        )

        if len(raw_list) == 0:
            raise ValueError("empty client model list")
        cts = [ct for _, ct in raw_list]
        if not all(isinstance(ct, CompressedTree) for ct in cts):
            raise ValueError("agg_compressed requires CompressedTree updates")
        if not all(ct.is_delta for ct in cts):
            raise ValueError("agg_compressed requires delta-encoded updates")
        if agg_robust:
            from fedml_tpu_torch.integrity import fused_robust_sum, parse_robust_spec

            if clip_factors is not None:
                raise ValueError(
                    "agg_robust cannot compose with norm-clip factors — the robust "
                    "statistic is unweighted, so there is no weight to fold the "
                    "clip into; pick one defense")
            mode, trim = parse_robust_spec(agg_robust)
            return tree_undelta(global_params, fused_robust_sum(cts, mode, trim))
        weights = FedMLAggOperator._weights(args, raw_list)
        if clip_factors is not None:
            weights = weights * torch.as_tensor(clip_factors, dtype=torch.float32)
        return tree_undelta(global_params, fused_weighted_sum(cts, weights))
