"""ServerAggregator — counterpart of
``fedml_tpu/core/alg_frame/server_aggregator.py``, with the reference's
hook order:

  on_before_aggregation:  central-DP clip → model-attack injection →
                          the defense's before-aggregation filter
  aggregate:              the defense's aggregation, or the FedAvg family's
                          weighted average (:class:`FedMLAggOperator`)
  on_after_aggregation:   central-DP noise → the defense's after hook

FHE comes with ROADMAP A13 and is refused when an aggregator is built.
Contribution assessment runs in the engines after aggregation
(``core/contribution``), as the reference's.
"""
from __future__ import annotations

import abc
import logging
from typing import Any, Dict, List, Tuple

from fedml_tpu_torch.compression import check_trust_stack
from fedml_tpu_torch.core.alg_frame.params import Context
from fedml_tpu_torch.utils.tree import Tree

logger = logging.getLogger(__name__)


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
        from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
            FedMLDifferentialPrivacy,
        )
        from fedml_tpu_torch.core.security.attacker import FedMLAttacker
        from fedml_tpu_torch.core.security.defender import FedMLDefender

        client_idxs = list(range(len(raw_client_model_list)))
        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_global_dp_enabled() and dp.is_clipping():
            raw_client_model_list = dp.global_clip(raw_client_model_list)
        attacker = FedMLAttacker.get_instance()
        if attacker.is_model_attack():
            raw_client_model_list = attacker.attack_model(
                raw_client_grad_list=raw_client_model_list, extra_auxiliary_info=None)
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            raw_client_model_list = defender.defend_before_aggregation(
                raw_client_grad_list=raw_client_model_list,
                extra_auxiliary_info=self.get_defense_aux())
            client_idxs = list(range(len(raw_client_model_list)))
        return raw_client_model_list, client_idxs

    def aggregate(self, raw_client_model_list: List[Tuple[int, Tree]]) -> Tree:
        from fedml_tpu_torch.core.security.defender import FedMLDefender
        from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator

        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            return defender.defend_on_aggregation(
                raw_client_grad_list=raw_client_model_list,
                base_aggregation_func=FedMLAggOperator.agg,
                extra_auxiliary_info=self.get_defense_aux())
        return FedMLAggOperator.agg(self.args, raw_client_model_list)

    def on_after_aggregation(self, aggregated_params: Tree) -> Tree:
        from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
            FedMLDifferentialPrivacy,
        )
        from fedml_tpu_torch.core.security.defender import FedMLDefender

        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_central_dp_enabled():
            aggregated_params = dp.add_global_noise(aggregated_params)
        defender = FedMLDefender.get_instance()
        if defender.is_defense_enabled():
            aggregated_params = defender.defend_after_aggregation(aggregated_params)
        return aggregated_params

    def get_defense_aux(self) -> Any:
        """What a defense may read beyond the updates (the reference's
        last-round metrics, from the Context)."""
        return Context().get(Context.KEY_METRICS_ON_LAST_ROUND)

    @abc.abstractmethod
    def test(self, params: Tree, test_data: Any, device: Any, args: Any) -> Dict:
        """Evaluate the aggregated model."""
