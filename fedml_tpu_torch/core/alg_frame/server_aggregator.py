"""ServerAggregator — counterpart of
``fedml_tpu/core/alg_frame/server_aggregator.py``.

The reference's hooks around aggregation run the trust stack (global-DP
clipping, model attacks, defenses, FHE, central DP); the port has none of
it yet (ROADMAP A10.2), so its arguments are refused when an aggregator is
built and the hooks pass their inputs through. ``aggregate`` is the
FedAvg family's weighted average (:class:`FedMLAggOperator`).
"""
from __future__ import annotations

import abc
from typing import Any, Dict, List, Tuple

from fedml_tpu_torch.compression import check_trust_stack
from fedml_tpu_torch.utils.tree import Tree


class ServerAggregator(abc.ABC):
    def __init__(self, model: Any = None, args: Any = None):
        check_trust_stack(args)
        self.model = model
        self.args = args
        self.id = 0
        self.is_enabled_test = True

    def set_id(self, aggregator_id: int) -> None:
        self.id = aggregator_id

    def on_before_aggregation(
        self, raw_client_model_list: List[Tuple[int, Tree]]
    ) -> Tuple[List[Tuple[int, Tree]], List[int]]:
        return raw_client_model_list, list(range(len(raw_client_model_list)))

    def aggregate(self, raw_client_model_list: List[Tuple[int, Tree]]) -> Tree:
        from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator

        return FedMLAggOperator.agg(self.args, raw_client_model_list)

    def on_after_aggregation(self, aggregated_params: Tree) -> Tree:
        return aggregated_params

    @abc.abstractmethod
    def test(self, params: Tree, test_data: Any, device: Any, args: Any) -> Dict:
        """Evaluate the aggregated model."""
