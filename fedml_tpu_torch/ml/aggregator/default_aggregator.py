"""Default ServerAggregator — counterpart of
``fedml_tpu/ml/aggregator/default_aggregator.py``."""
from __future__ import annotations

from typing import Any

from fedml_tpu_torch.core.alg_frame.server_aggregator import ServerAggregator
from fedml_tpu_torch.ml.trainer.classification_trainer import evaluate_on
from fedml_tpu_torch.ml.trainer.local_sgd import build_evaluator
from fedml_tpu_torch.models import layers
from fedml_tpu_torch.utils.tree import Tree


class DefaultServerAggregator(ServerAggregator):
    def __init__(self, model, args):
        super().__init__(model, args)
        self.apply_fn = lambda params, x: layers.apply(model, params, x)
        self._evaluate = build_evaluator(self.apply_fn)

    def test(self, params: Tree, test_data, device, args) -> dict:
        return evaluate_on(self._evaluate, params, test_data, device)


def create_server_aggregator(model: Any, args: Any) -> ServerAggregator:
    return DefaultServerAggregator(model, args)
