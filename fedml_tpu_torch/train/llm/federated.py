"""Federated LLM fine-tuning — counterpart of
``fedml_tpu/train/llm/federated.py`` (``LLMClientTrainer``,
``LLMAggregator``).

Each client runs the trainer's step over its own token shard; with LoRA
only the adapter dict (``{reference path: tensor}``) is exchanged. As in
the reference the classes are a ``ClientTrainer`` and a
``ServerAggregator``, so the host-loop round (``run_fedllm``) runs the
trust-stack hook chain around each client's payload: data poisoning and
local DP around ``train`` (``run_local_training``), the central-DP clip,
model attacks and defenses before the weighted average, central DP and
the defenses' after-hook behind it. The on-device round runs no hook.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from fedml_tpu_torch.core.alg_frame.client_trainer import ClientTrainer
from fedml_tpu_torch.core.alg_frame.server_aggregator import ServerAggregator
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.models.llm.llama import LlamaConfig
from fedml_tpu_torch.train.llm.trainer import LLMTrainer


class LLMClientTrainer(ClientTrainer):
    """``train(params, train_data, device, args)`` consumes the exchangeable
    params, runs ``args.epochs`` of local steps and returns the updated
    exchangeable params with its metrics."""

    def __init__(self, cfg: LlamaConfig, args: Any, device: DeviceLike = "cuda"):
        super().__init__(model=None, args=args)
        self.engine = LLMTrainer(cfg, args, device=device)
        self.engine.init(seed=int(getattr(args, "random_seed", 0)))
        self.lora_only = self.engine.lora_only
        self._round_seed = 0

    def set_id(self, trainer_id: int) -> None:
        self.id = int(trainer_id)

    def set_round(self, round_idx: int) -> None:
        self._round_seed = int(round_idx)

    def get_exchange_params(self):
        return self.engine.exchange_state()

    def set_exchange_params(self, exchanged) -> None:
        self.engine.load_exchange_state(exchanged)

    def train(self, params, train_data, device, args) -> Tuple[Any, Dict]:
        """(new_exchange_params, metrics), with the reference's shuffling
        seed and pad-and-mask of the trailing partial batch."""
        self.set_exchange_params(params)
        x, y = (np.asarray(a) for a in train_data)
        batch = self.engine.batch_size
        epochs = int(getattr(args, "epochs", 1))
        seed = (int(getattr(args, "random_seed", 0)) * 9973 + self.id * 1009
                + self._round_seed)
        rng = np.random.default_rng(seed)
        n = x.shape[0]
        losses = []
        for _ in range(epochs):
            order = rng.permutation(n)
            for i in range(0, n, batch):
                idx = order[i: i + batch]
                m = np.ones((batch,), np.float32)
                if len(idx) < batch:
                    m[len(idx):] = 0.0
                    idx = np.concatenate(
                        [idx, np.full(batch - len(idx), idx[0] if len(idx) else 0)]
                    ).astype(idx.dtype)
                losses.append(self.engine.step(x[idx], y[idx], m))
        self.local_sample_number = n
        metrics = {"train_loss": float(np.mean(losses)) if losses else 0.0,
                   "train_samples": float(n)}
        return self.get_exchange_params(), metrics

    def test(self, params, test_data, device, args) -> Dict:
        self.set_exchange_params(params)
        x, y = test_data
        n = min(len(x), self.engine.batch_size * 8)
        return self.engine.evaluate(np.asarray(x[:n]), np.asarray(y[:n]))


class LLMAggregator(ServerAggregator):
    """Holds the global exchange state, aggregates the round's payloads
    through the hook chain and evaluates the global adapters."""

    def __init__(self, cfg: LlamaConfig, args: Any, device: DeviceLike = "cuda",
                 engine: Optional[LLMTrainer] = None):
        super().__init__(model=None, args=args)
        self.engine = engine or LLMTrainer(cfg, args, device=device)
        if self.engine.params is None:
            self.engine.init(seed=int(getattr(args, "random_seed", 0)))
        self.lora_only = self.engine.lora_only

    def get_init_params(self):
        return self.engine.exchange_state()

    def set_global_params(self, exchanged) -> None:
        self.engine.load_exchange_state(exchanged)

    def test(self, params, test_data, device, args) -> Dict:
        self.set_global_params(params)
        x, y = test_data
        n = min(len(x), self.engine.batch_size * 8)
        metrics = self.engine.evaluate(np.asarray(x[:n]), np.asarray(y[:n]))
        return {"test_loss": metrics["eval_loss"], "test_acc": metrics["eval_acc"]}

    def save_round(self, ckpt_dir: str, round_idx: int) -> str:
        return self.engine.save_checkpoint(ckpt_dir, round_idx)
