"""Default ClientTrainer for classification and sequence tasks —
counterpart of ``fedml_tpu/ml/trainer/classification_trainer.py``.

A client's arrays are batched with the reference's seeds
(``batch_epochs``), moved to the device once per client (pinned, on the
card), trained by ``local_sgd``'s loop, and its metrics are read back once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.core.alg_frame.client_trainer import ClientTrainer
from fedml_tpu_torch.data.dataset import batch_epochs
from fedml_tpu_torch.ml.trainer.local_sgd import (
    build_evaluator,
    build_local_fn,
    init_local_state,
    fp32_precision,
)
from fedml_tpu_torch.models import layers
from fedml_tpu_torch.utils.tree import Tree, tree_sub


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``: one copy, from pinned memory on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class ClassificationTrainer(ClientTrainer):
    def __init__(self, model, args):
        super().__init__(model, args)
        self.apply_fn = lambda params, x: layers.apply(model, params, x)
        self._run_local = build_local_fn(self.apply_fn, args)
        self._evaluate = build_evaluator(self.apply_fn)
        self._pad_to_batches: Optional[int] = None
        self._round_seed = 0
        self._server_state: dict = {}

    def set_pad_to_batches(self, n: Optional[int]) -> None:
        self._pad_to_batches = n

    def set_round(self, round_idx: int) -> None:
        self._round_seed = round_idx

    def set_server_state(self, server_state: dict) -> None:
        self._server_state = dict(server_state or {})

    def train(self, params: Tree, train_data: Tuple[np.ndarray, np.ndarray],
              device, args) -> Tuple[Tree, dict]:
        device = torch.device(device)
        x, y = train_data
        state = init_local_state(params, args)
        if self._server_state.get("c_global") is not None:
            state = state._replace(c_global=self._server_state["c_global"])
        xs, ys, mask = batch_epochs(
            np.asarray(x), np.asarray(y),
            int(getattr(args, "batch_size", 32)),
            int(getattr(args, "epochs", 1)),
            seed=int(getattr(args, "random_seed", 0)) * 100003
            + self.id * 1009 + self._round_seed,
            pad_to_batches=self._pad_to_batches,
        )
        valid_steps = mask.sum(1) > 0
        xs, ys, mask = (to_device(a, device) for a in (xs, ys, mask))
        with fp32_precision(device):
            new_params, new_state, metrics = self._run_local(
                params, state, xs, ys, mask, valid_steps=valid_steps)
        scalars = [k for k, v in metrics.items()
                   if isinstance(v, torch.Tensor) and v.ndim == 0]
        values = torch.stack([metrics[k] for k in scalars]).cpu().tolist()
        metrics.update(zip(scalars, values))  # the client's one sync
        metrics["scaffold_c_delta"] = None
        if new_state.c_local is not None:
            metrics["scaffold_c_delta"] = tree_sub(new_state.c_local, state.c_local)
        return new_params, metrics

    def test(self, params: Tree, test_data, device, args) -> dict:
        return evaluate_on(self._evaluate, params, test_data, device)


def evaluate_on(evaluate, params: Tree, test_data, device) -> dict:
    """The reference's test metrics of ``params`` on ``(x, y)``."""
    device = torch.device(device)
    x, y = test_data
    with fp32_precision(device):
        loss_sum, correct, n = evaluate(params, to_device(np.asarray(x), device),
                                        to_device(np.asarray(y), device))
    loss_sum, correct = torch.stack([loss_sum, correct]).cpu().tolist()
    return {
        "test_loss": loss_sum / max(n, 1.0),
        "test_acc": correct / max(n, 1.0),
        "test_total": n,
        "test_correct": correct,
    }
