"""ClientTrainer — counterpart of ``fedml_tpu/core/alg_frame/client_trainer.py``.

Parameters are an explicit ``{path: tensor}`` argument and return value,
never cached in the operator. The hooks around local training run the
client side of the trust stack, as the reference's: data poisoning before
(``FedMLAttacker``), local DP noise after (``FedMLDifferentialPrivacy``).
FHE comes with ROADMAP A13 and is refused when a trainer is built.

``trust_stream`` keys this trainer's attacker and DP state: None in the sp
simulation (one process-wide stream, as the reference's sequential loop),
the silo's rank in cross-silo, so in-process silos each draw what their
own process would.
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
        self.trust_stream = None

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
        """Data poisoning (reference ``client_trainer.py:59-69``)."""
        from fedml_tpu_torch.core.security.attacker import FedMLAttacker

        attacker = FedMLAttacker.get_instance()
        if attacker.is_data_poisoning_attack() and attacker.is_to_poison_data():
            train_data = attacker.poison_data(train_data, stream=self.trust_stream)
        return params, train_data

    def on_after_local_training(self, params: Tree, train_data: Any,
                                device: Any, args: Any) -> Tree:
        """Local-DP noise (reference ``:71-85``)."""
        from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
            FedMLDifferentialPrivacy,
        )

        dp = FedMLDifferentialPrivacy.get_instance()
        if dp.is_local_dp_enabled():
            params = dp.add_local_noise(params, stream=self.trust_stream)
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
