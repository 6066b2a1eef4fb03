"""FedLLM — the federated LoRA round loop, counterpart of
``fedml_tpu/train/llm/run_fedllm.py``.

N simulated clients share one trainer (sequential local training, the
reference's ``sp`` memory model) and exchange LoRA dicts, or every
parameter without LoRA (full-parameter training; the clients' payloads,
the global state and the aggregate are then each a whole model on the
device, as the reference holds them). Two rounds, as the reference's:

* the host loop (the default): each sampled client trains from the
  global adapters through ``run_local_training`` (data poisoning and local
  DP around ``train``), then the aggregator's hook chain (central-DP clip,
  model attack, defense, the weighted average, central DP, the defense's
  after-hook) makes the new global adapters;
* ``on_device_round: true``: the round without hooks, one
  :meth:`LLMTrainer.compile_federated_round` call over the clients'
  batches drawn with the reference's seeded draws; refused while a
  trust-stack hook is on, and for a full model (the trainer raises at the
  first round, as the reference's does).

Both test the global adapters on the reference's cadence and, with
``checkpoint_dir`` and ``save_every_rounds``, save the engine's live
adapters as the reference does (``LLMAggregator.save_round``): after a
tested round those are the global adapters, after an untested one the
last client's.

Both forms of the round are bracketed by the ``round`` profiler event
(``MLOpsProfilerEvent``: ``<log_file_dir>/run_<run_id>/events.jsonl``,
flushed at the end of ``train()``). The event's wall is host time: the
host loop's ends after the aggregate has been enqueued, the fused round's
after its loss has been read back.
"""
from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple

import numpy as np

from fedml_tpu_torch.core.mlops.event import MLOpsProfilerEvent
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
        device = "cuda" if device is None else device
        self.args = args
        self.dataset = dataset
        self.cfg = cfg or LlamaConfig.from_args(args, vocab_size=dataset.class_num)
        self.client = LLMClientTrainer(self.cfg, args, device=device)
        self.aggregator = LLMAggregator(self.cfg, args, engine=self.client.engine)
        self.global_exchange = self.aggregator.get_init_params()
        self.event = MLOpsProfilerEvent(args)
        self.test_history: List[dict] = []
        # the fused round never surfaces a client's payload to the host, so
        # it and the trust-stack hooks exclude each other
        self.on_device = bool(getattr(args, "on_device_round", False))
        self._fed_round = None
        self._fed_round_key = None
        if self.on_device:
            self._check_no_host_hooks()

    def _check_no_host_hooks(self) -> None:
        from fedml_tpu_torch.compression import check_trust_stack
        from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
            FedMLDifferentialPrivacy,
        )
        from fedml_tpu_torch.core.security.attacker import FedMLAttacker
        from fedml_tpu_torch.core.security.defender import FedMLDefender

        check_trust_stack(self.args)  # FHE: not ported, refused naming A13
        active = [name for name, on in (
            ("attack", FedMLAttacker.get_instance().is_attack_enabled()),
            ("defense", FedMLDefender.get_instance().is_defense_enabled()),
            ("dp", FedMLDifferentialPrivacy.get_instance().is_dp_enabled())) if on]
        if active:
            raise ValueError(
                f"on_device_round: true is incompatible with host-side trust-stack "
                f"hooks (active: {', '.join(active)}) — the fused round never "
                f"surfaces per-client payloads to the host; disable the hooks or "
                f"drop on_device_round")

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
        """One round: the host loop, or the on-device round; then the test
        and the checkpoint on their cadences. Returns the round's report."""
        if self.on_device:
            return self._train_one_round_on_device(round_idx)
        client_ids = sample_clients(self.args, round_idx)
        payloads = []
        self.event.log_event_started("round", round_idx)
        t0 = time.time()
        for cid in client_ids:
            self.client.set_id(cid)
            self.client.set_round(round_idx)
            updated, _ = self.client.run_local_training(
                self.global_exchange, self.dataset.train_data_local_dict[cid], None,
                self.args)
            payloads.append((float(self.dataset.train_data_local_num_dict[cid]), updated))
        model_list, _ = self.aggregator.on_before_aggregation(payloads)
        self.global_exchange = self.aggregator.aggregate(model_list)
        self.global_exchange = self.aggregator.on_after_aggregation(self.global_exchange)
        dt = time.time() - t0
        self.event.log_event_ended("round", round_idx)
        report = {"round": round_idx, "round_sec": dt}
        self._maybe_test_and_checkpoint(round_idx, report)
        return report

    def _train_one_round_on_device(self, round_idx: int) -> Dict:
        """The fused round: sample, assemble, one fused round."""
        engine = self.client.engine
        xs, ys, ms, weights = self.round_batch(round_idx)
        key = xs.shape[:2]
        if self._fed_round_key != key:
            self._fed_round = engine.compile_federated_round(*key)
            self._fed_round_key = key
        self.event.log_event_started("round", round_idx)
        t0 = time.time()
        _, _, self.global_exchange, loss = self._fed_round(
            engine.params, engine.opt_state, self.global_exchange, xs, ys, ms, weights)
        loss = float(loss)  # waits for the device before the clock stops
        dt = time.time() - t0
        self.event.log_event_ended("round", round_idx)
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
            t0 = time.perf_counter()
            report["checkpoint"] = self.aggregator.save_round(str(ckpt_dir), round_idx)
            report["checkpoint_ms"] = (time.perf_counter() - t0) * 1e3
            report["checkpoint_bytes"] = self.client.engine.last_save_bytes

    def train(self) -> Dict:
        t0 = time.time()
        rounds = int(getattr(self.args, "comm_round", 1))
        for r in range(rounds):
            self.train_one_round(r)
        wall = time.time() - t0
        self.event.flush()
        final = self.test_history[-1] if self.test_history else {}
        return {
            "wall_clock_sec": wall,
            "rounds": rounds,
            "rounds_per_sec": rounds / max(wall, 1e-9),
            **final,
        }
