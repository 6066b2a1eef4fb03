"""TrainerDistAdapter — counterpart of
``fedml_tpu/cross_silo/client/trainer_dist_adapter.py``: the silo's
trainer behind the FSM, with one batch count shared by every silo (the
reference's pad-and-mask, padded steps skipped as in ``local_sgd``).

Training inside a silo over several devices (``n_proc_in_silo > 1``, a
JAX mesh in the reference) comes with the multi-GPU layer (ROADMAP A11).
"""
from __future__ import annotations

import math
from typing import Any, Tuple

from fedml_tpu_torch.data.dataset import FederatedDataset
from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer
from fedml_tpu_torch.utils.tree import Tree


class TrainerDistAdapter:
    def __init__(self, args: Any, device: Any, client_rank: int, model: Any,
                 dataset: FederatedDataset, client_trainer=None):
        if int(getattr(args, "n_proc_in_silo", 1)) > 1:
            raise NotImplementedError(
                "n_proc_in_silo > 1: training a silo over several devices comes with "
                "the multi-GPU layer (ROADMAP A11)")
        self.args = args
        self.device = device
        self.client_rank = int(client_rank)
        self.dataset = dataset
        self.trainer = client_trainer or create_model_trainer(model, args)
        self.trainer.set_id(self.client_rank)
        self.client_index = self.client_rank - 1
        max_n = max(dataset.train_data_local_num_dict.values())
        self.trainer.set_pad_to_batches(
            max(1, math.ceil(max_n / int(getattr(args, "batch_size", 32)))))
        self.last_train_metrics: dict = {}

    def update_dataset(self, client_index: int) -> None:
        self.client_index = int(client_index)

    def train(self, round_idx: int, global_params: Tree) -> Tuple[Tree, int]:
        self.trainer.set_round(round_idx)
        train_data = self.dataset.train_data_local_dict[self.client_index]
        n_samples = self.dataset.train_data_local_num_dict[self.client_index]
        new_params, metrics = self.trainer.run_local_training(
            global_params, train_data, self.device, self.args)
        self.last_train_metrics = metrics  # FedNova's tau and the health fields
        return new_params, int(n_samples)
