"""Single-process federated simulation ("Parrot" sp backend) — counterpart of
``fedml_tpu/simulation/sp/fedavg_api.py``.

One round loop serves every federated optimizer the reference's sp engine
does (FedAvg, FedProx, FedOpt, FedNova, FedDyn, SCAFFOLD, Mime): the local
differences live in ``ml/trainer/local_sgd.py``, the server differences in
``ServerOptimizer``. Clients train one after another on the engine's
device; the global model stays there between rounds.

With ``compression`` set, every upload goes through the wire as in the
reference: the client's delta against the round's global model, plus its
error-feedback residual, is encoded with the round's ``derive_key`` — in
the reference's layout (``models/convert.to_reference_layout``), so the
wire arrays are the reference's element for element — and the server
aggregates the encoded deltas with the dequant-fused weighted sum.

Not ported yet, and refused when their arguments are set: the trust stack
(DP, FHE, attacks, defenses, integrity screening, quarantine and rollback,
robust aggregation, contribution assessment: ROADMAP A10), round
checkpoints and resume (A4), and trace capture and spans (A12). The
``sp/rounds`` counter and the ``sp/client_train_ms``, ``sp/encode_ms`` and
``sp/aggregate_ms`` histograms go to the port's metrics registry.
"""
from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression import (
    ErrorFeedback,
    check_trust_stack,
    derive_key,
    get_codec,
    tree_delta,
)
from fedml_tpu_torch.core.alg_frame.params import Context
from fedml_tpu_torch.data.dataset import FederatedDataset
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator
from fedml_tpu_torch.ml.aggregator.default_aggregator import create_server_aggregator
from fedml_tpu_torch.ml.aggregator.server_optimizer import ServerOptimizer
from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer
from fedml_tpu_torch.models import model_hub
from fedml_tpu_torch.models.convert import from_reference_layout, to_reference_layout
from fedml_tpu_torch.simulation.sampling import sample_clients
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.tree import (
    Tree,
    tree_add,
    tree_map,
    tree_scale,
    tree_stack,
    weighted_tree_sum,
)

logger = logging.getLogger(__name__)

# arguments of features this engine does not have yet → the ROADMAP item
_NOT_PORTED = {
    "checkpoint_dir": "round checkpoints (ROADMAP A4)",
    "resume": "resume from a round checkpoint (ROADMAP A4)",
    "trace_rounds": "trace capture (ROADMAP A12)",
}


class _Stopwatch:
    """Milliseconds of device work between :meth:`start` and :meth:`stop`:
    CUDA events on the card (read at the round's end, no extra sync inside
    the round), the host clock on the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.spans: List[Tuple[Any, Any]] = []

    def start(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def stop(self, started) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.spans.append((started, ev))
        else:
            self.spans.append((started, time.perf_counter()))

    def total_ms(self) -> float:
        if self.cuda:
            if self.spans:
                self.spans[-1][1].synchronize()
            ms = sum(a.elapsed_time(b) for a, b in self.spans)
        else:
            ms = sum((b - a) * 1e3 for a, b in self.spans)
        self.spans = []
        return float(ms)


class FedAvgAPI:
    def __init__(self, args: Any, device: Any, dataset: FederatedDataset,
                 model: Any, client_trainer=None, server_aggregator=None):
        check_trust_stack(args)
        for arg, what in _NOT_PORTED.items():
            if getattr(args, arg, None):
                raise NotImplementedError(
                    f"{arg}: {what} is not ported to the sp engine yet")
        self.args = args
        self.device = resolve_device(device)
        self.dataset = dataset
        self.model = model
        self.trainer = client_trainer or create_model_trainer(model, args)
        self.aggregator = server_aggregator or create_server_aggregator(model, args)
        self.server_opt = ServerOptimizer(args)
        batch = int(getattr(args, "batch_size", 32))
        sample_x = dataset.train_data_global[0][:batch]
        self.global_params: Tree = model_hub.init_params(model, args, sample_x,
                                                         self.device)
        # one batch count shared by every client (the reference's
        # pad-and-mask; padded steps are skipped, see local_sgd)
        max_n = max(dataset.train_data_local_num_dict.values())
        self.trainer.set_pad_to_batches(max(1, math.ceil(max_n / batch)))
        self.test_history: List[dict] = []
        self._c_global: Optional[Tree] = None  # SCAFFOLD server control variate
        self._mime_s: Optional[Tree] = None  # Mime server momentum
        self._mime_beta = float(getattr(args, "mime_beta", 0.9))
        reg = get_registry()
        self._m_client_ms = reg.histogram("sp/client_train_ms")
        self._m_encode_ms = reg.histogram("sp/encode_ms")
        self._m_aggregate_ms = reg.histogram("sp/aggregate_ms")
        self._m_rounds = reg.counter("sp/rounds")
        self._codec = get_codec(getattr(args, "compression", ""), args)
        self._ef_by_client: Dict[int, ErrorFeedback] = {}

    # -- client sampling (parity: fedavg_api.py:198) -------------------------
    def _client_sampling(self, round_idx: int) -> List[int]:
        return sample_clients(self.args, round_idx)

    # -- compressed uplink simulation ----------------------------------------
    def _compress_uplinks(self, round_idx: int, client_ids: List[int],
                          w_locals: List[Tuple[int, Tree]], enc_watch: _Stopwatch,
                          agg_watch: _Stopwatch) -> Tuple[Tree, List[int]]:
        """Each client's update through the wire: its delta against the
        global model plus its error-feedback residual, encoded with
        ``derive_key(seed, round, client)``. Returns the dequant-fused
        aggregate and each client's uplink bytes."""
        seed = int(getattr(self.args, "random_seed", 0))
        started = enc_watch.start()
        pairs = []
        for cid, (n_k, w) in zip(client_ids, w_locals):
            ef = self._ef_by_client.setdefault(cid, ErrorFeedback(self._codec))
            delta = to_reference_layout(tree_delta(w, self.global_params))
            pairs.append((n_k, ef.encode(delta, key=derive_key(seed, round_idx, cid))))
        enc_watch.stop(started)
        started = agg_watch.start()
        w_agg = from_reference_layout(FedMLAggOperator.agg_compressed(
            self.args, pairs, to_reference_layout(self.global_params)))
        agg_watch.stop(started)
        return w_agg, [ct.wire_nbytes() for _, ct in pairs]

    # -- round ----------------------------------------------------------------
    def train_one_round(self, round_idx: int) -> dict:
        client_ids = self._client_sampling(round_idx)
        ctx = Context()
        ctx.add(Context.KEY_CLIENT_ID_LIST_IN_THIS_ROUND, client_ids)
        ctx.add(Context.KEY_CLIENT_NUM_IN_THIS_ROUND, len(client_ids))

        w_locals: List[Tuple[int, Tree]] = []
        c_deltas, taus, mime_grads = [], [], []
        server_state = {}
        # SCAFFOLD's control variate and Mime's server momentum share the
        # one server_state slot the local trainer reads
        if self._c_global is not None and self._mime_s is not None:
            raise RuntimeError(
                "server_state slot conflict: SCAFFOLD c_global and Mime "
                "momentum are both live; one run supports one server-stateful "
                "optimizer")
        if self._c_global is not None:
            server_state["c_global"] = self._c_global
        if self._mime_s is not None:
            server_state["c_global"] = self._mime_s
        for cid in client_ids:
            self.trainer.set_id(cid)
            self.trainer.set_round(round_idx)
            self.trainer.set_server_state(server_state)
            train_data = self.dataset.train_data_local_dict[cid]
            n_k = self.dataset.train_data_local_num_dict[cid]
            t0 = time.perf_counter()
            w, metrics = self.trainer.run_local_training(
                self.global_params, train_data, self.device, self.args)
            self._m_client_ms.observe((time.perf_counter() - t0) * 1e3)
            if metrics.get("scaffold_c_delta") is not None:
                c_deltas.append(metrics["scaffold_c_delta"])
            if metrics.get("mime_full_grad") is not None:
                mime_grads.append(metrics["mime_full_grad"])
            taus.append(float(metrics.get("local_steps", 0.0)))
            w_locals.append((n_k, w))

        enc_watch, agg_watch = _Stopwatch(self.device), _Stopwatch(self.device)
        wire = None
        if self._codec is not None:
            w_agg, wire = self._compress_uplinks(round_idx, client_ids, w_locals,
                                                 enc_watch, agg_watch)
        else:
            started = agg_watch.start()
            w_list, _ = self.aggregator.on_before_aggregation(w_locals)
            w_agg = self.aggregator.aggregate(w_list)
            w_agg = self.aggregator.on_after_aggregation(w_agg)
            agg_watch.stop(started)
        tau_eff = None
        if str(getattr(self.args, "federated_optimizer", "")) == "FedNova" and taus:
            counts = np.asarray([float(n) for n, _ in w_locals])
            tau_eff = float(np.sum(counts / counts.sum() * np.asarray(taus)))
        self.global_params = self.server_opt.step(self.global_params, w_agg,
                                                  tau_eff=tau_eff)
        if mime_grads:  # s ← (1−β)·avg(ḡ_i) + β·s
            avg_g = tree_map(lambda *xs: sum(xs) / len(xs), *mime_grads)
            if self._mime_s is None:
                self._mime_s = avg_g
            else:
                b = self._mime_beta
                self._mime_s = tree_map(lambda s, g: b * s + (1.0 - b) * g,
                                        self._mime_s, avg_g)
        if c_deltas:  # SCAFFOLD: c += (1/N) * sum(c_deltas) * (S/N)
            total = int(self.args.client_num_in_total)
            avg_delta = tree_scale(
                weighted_tree_sum(tree_stack(c_deltas),
                                  np.full(len(c_deltas), 1.0 / len(c_deltas))),
                len(c_deltas) * (1.0 / total))
            if self._c_global is None:
                self._c_global = tree_map(lambda x: 0 * x, avg_delta)
            self._c_global = tree_add(self._c_global, avg_delta)
        self._m_rounds.inc()

        report: Dict[str, Any] = {"round": round_idx, "clients": client_ids}
        freq = int(getattr(self.args, "frequency_of_the_test", 1))
        do_eval = (round_idx % max(freq, 1) == 0
                   or round_idx == int(self.args.comm_round) - 1)
        metrics = None
        if do_eval:
            metrics = self.aggregator.test(self.global_params,
                                           self.dataset.test_data_global,
                                           self.device, self.args)
        if self._codec is not None:
            report["encode_ms"] = enc_watch.total_ms()
            self._m_encode_ms.observe(report["encode_ms"])
            report["uplink_bytes"] = wire
        report["aggregate_ms"] = agg_watch.total_ms()
        self._m_aggregate_ms.observe(report["aggregate_ms"])
        if metrics is not None:
            report.update(metrics)
            self.test_history.append(report)
            logger.info("round %d acc=%.4f loss=%.4f", round_idx,
                        metrics.get("test_acc", -1), metrics.get("test_loss", -1))
        return report

    def train(self) -> dict:
        t0 = time.time()
        for round_idx in range(int(self.args.comm_round)):
            self.train_one_round(round_idx)
        wall = time.time() - t0
        final = self.test_history[-1] if self.test_history else {}
        return {
            "wall_clock_sec": wall,
            "rounds": int(self.args.comm_round),
            "rounds_per_sec": int(self.args.comm_round) / max(wall, 1e-9),
            **final,
        }


__all__ = ["FedAvgAPI"]
