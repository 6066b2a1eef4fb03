"""ClientTrainer — counterpart of ``fedml_tpu/core/alg_frame/client_trainer.py``.

Parameters are an explicit ``{path: tensor}`` argument and return value,
never cached in the operator. The reference's hooks around local training
run the trust stack (data poisoning, FHE, local DP); the port has none of
it yet (ROADMAP A10.2), so its arguments are refused when a trainer is built
and the hooks pass their inputs through.
"""
from __future__ import annotations

import abc
from typing import Any, Tuple

from fedml_tpu_torch.compression import check_trust_stack
from fedml_tpu_torch.utils.tree import Tree


class ClientTrainer(abc.ABC):
    """Abstract client training operator (params in → params out)."""

    def __init__(self, model: Any = None, args: Any = None):
        check_trust_stack(args)
        self.model = model  # the model *definition*, never its weights
        self.args = args
        self.id = 0
        self.local_sample_number = 0

    def set_id(self, trainer_id: int) -> None:
        self.id = trainer_id

    # engine-contract hooks (overridden where meaningful; no-ops otherwise)
    def set_pad_to_batches(self, n) -> None:
        """Share one batch count across heterogeneous clients."""

    def set_round(self, round_idx: int) -> None:
        """Give the trainer the round index (per-round data shuffling)."""

    def set_server_state(self, server_state: dict) -> None:
        """Round-scoped algorithm state pushed by the engine (SCAFFOLD's
        c_global, Mime's server momentum)."""

    def on_before_local_training(self, params: Tree, train_data: Any,
                                 device: Any, args: Any) -> Tuple[Tree, Any]:
        return params, train_data

    def on_after_local_training(self, params: Tree, train_data: Any,
                                device: Any, args: Any) -> Tree:
        return params

    @abc.abstractmethod
    def train(self, params: Tree, train_data: Any, device: Any,
              args: Any) -> Tuple[Tree, dict]:
        """Run local training; return (new_params, metrics)."""

    def test(self, params: Tree, test_data: Any, device: Any, args: Any) -> dict:
        return {}

    def run_local_training(self, params: Tree, train_data: Any, device: Any,
                           args: Any) -> Tuple[Tree, dict]:
        params, train_data = self.on_before_local_training(
            params, train_data, device, args)
        new_params, metrics = self.train(params, train_data, device, args)
        new_params = self.on_after_local_training(new_params, train_data, device, args)
        return new_params, metrics
