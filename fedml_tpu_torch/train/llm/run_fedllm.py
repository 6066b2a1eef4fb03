"""FedLLM — the federated LoRA round loop, counterpart of
``fedml_tpu/train/llm/run_fedllm.py``.

N simulated clients share one trainer (sequential local training, the
reference's ``sp`` memory model) and exchange LoRA dicts. The port runs
the on-device round (``on_device_round: true``): each round samples the
clients, assembles their batches with the reference's seeded draws, runs
one :meth:`LLMTrainer.compile_federated_round` round and tests the global
adapters on the reference's cadence. The host-loop round, whose point is
the trust-stack hooks around each client's payload, is not ported: the
attack, defense and DP hooks exist (ROADMAP A10.2a), and its contribution
hook comes with A10.2c.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from fedml_tpu_torch.data.dataset import FederatedDataset
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.models.llm.llama import LlamaConfig
from fedml_tpu_torch.simulation.sampling import sample_clients
from fedml_tpu_torch.train.llm.federated import LLMAggregator, LLMClientTrainer

logger = logging.getLogger(__name__)


class FedLLMAPI:
    """Round loop: sample clients → local LoRA steps → weighted average.

    ``device`` defaults to ``"cuda"`` (``None`` means the same); pass
    ``"cpu"`` to run on the CPU. The trainer reads its settings from the
    same flat ``args`` bag, QLoRA's ``base_quantize``,
    ``base_quantize_min_size`` and ``base_quantize_block`` among them."""

    def __init__(self, args: Any, device: DeviceLike, dataset: FederatedDataset,
                 cfg: LlamaConfig = None):
        if not bool(getattr(args, "on_device_round", False)):
            raise NotImplementedError(
                "the port runs on_device_round: true only; the host-loop round "
                "and its contribution-assessment hook are not ported yet (ROADMAP "
                "A10.2c)")
        device = "cuda" if device is None else device
        self.args = args
        self.dataset = dataset
        self.cfg = cfg or LlamaConfig.from_args(args, vocab_size=dataset.class_num)
        self.client = LLMClientTrainer(self.cfg, args, device=device)
        self.aggregator = LLMAggregator(self.cfg, args, engine=self.client.engine)
        self.global_exchange = self.aggregator.get_init_params()
        self.test_history: List[dict] = []
        self._fed_round = None
        self._fed_round_key = None

    def round_batch(self, round_idx: int) -> Tuple[np.ndarray, ...]:
        """``(xs, ys, ms, weights)`` of a round: the sampled clients'
        ``[clients, steps, B, T]`` token batches drawn from each client's
        shard with ``default_rng(seed * 9973 + round)``, as the reference."""
        engine = self.client.engine
        client_ids = sample_clients(self.args, round_idx)
        batch = engine.batch_size
        steps = int(getattr(self.args, "local_steps_per_round", 0) or 0)
        if steps <= 0:  # default: one optimizer step per local epoch
            steps = int(getattr(self.args, "epochs", 1))
        xs = np.zeros((len(client_ids), steps, batch, engine.seq_len), np.int32)
        ys = np.zeros_like(xs)
        ms = np.ones((len(client_ids), steps, batch), np.float32)
        weights = np.zeros((len(client_ids),), np.float32)
        rng = np.random.default_rng(
            int(getattr(self.args, "random_seed", 0)) * 9973 + round_idx)
        for i, cid in enumerate(client_ids):
            x, y = self.dataset.train_data_local_dict[cid]
            x, y = np.asarray(x), np.asarray(y)
            idx = rng.integers(0, x.shape[0], size=(steps, batch))
            xs[i], ys[i] = x[idx], y[idx]
            weights[i] = float(self.dataset.train_data_local_num_dict[cid])
        return xs, ys, ms, weights

    def train_one_round(self, round_idx: int) -> Dict:
        """One on-device round: sample, assemble, one fused round, then
        test on the cadence. Returns the round's report."""
        engine = self.client.engine
        xs, ys, ms, weights = self.round_batch(round_idx)
        key = xs.shape[:2]
        if self._fed_round_key != key:
            self._fed_round = engine.compile_federated_round(*key)
            self._fed_round_key = key
        t0 = time.time()
        _, _, self.global_exchange, loss = self._fed_round(
            engine.params, engine.opt_state, self.global_exchange, xs, ys, ms, weights)
        loss = float(loss)  # waits for the device before the clock stops
        dt = time.time() - t0
        report = {"round": round_idx, "round_sec": dt, "train_loss": loss}
        self._maybe_test_and_checkpoint(round_idx, report)
        return report

    def _maybe_test_and_checkpoint(self, round_idx: int, report: Dict) -> None:
        freq = int(getattr(self.args, "frequency_of_the_test", 1))
        if round_idx % max(freq, 1) == 0 or round_idx == int(
                getattr(self.args, "comm_round", 1)) - 1:
            metrics = self.aggregator.test(
                self.global_exchange, self.dataset.test_data_global, None, self.args)
            report.update(metrics)
            self.test_history.append(report)
            logger.info("fedllm round %d: %s", round_idx, metrics)
        ckpt_dir = getattr(self.args, "checkpoint_dir", None)
        every = int(getattr(self.args, "save_every_rounds", 0) or 0)
        if ckpt_dir and every and round_idx % every == 0:
            self.aggregator.save_round(str(ckpt_dir), round_idx)

    def train(self) -> Dict:
        t0 = time.time()
        rounds = int(getattr(self.args, "comm_round", 1))
        for r in range(rounds):
            self.train_one_round(r)
        wall = time.time() - t0
        final = self.test_history[-1] if self.test_history else {}
        return {
            "wall_clock_sec": wall,
            "rounds": rounds,
            "rounds_per_sec": rounds / max(wall, 1e-9),
            **final,
        }
