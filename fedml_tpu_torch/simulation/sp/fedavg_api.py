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

The trust stack runs as in the reference. Attacks, defenses and DP are
the singletons' (``fedml_tpu_torch.init`` configures them) and run through
the trainer's and the aggregator's hooks. The three integrity rings
(``integrity: true``, ``agg_robust``) are this engine's: quarantined
clients sit out the selection; each upload is screened as encoded (or as
its raw displacement without a codec), and a screened upload is dropped,
its sender quarantined and its error-feedback residual reset; with a codec
the aggregate is the fused weighted mean, with a norm-only defense's clip
factors, or the fused robust statistic, unless a hook needs the decoded
client models (``compression.requires_full_trees``); after the eval the
acceptance guard may reject the round, which is rolled back to its
round-open state and re-run with a fresh cohort.

With ``enable_contribution`` each round's kept client models are valued
after aggregation (``core/contribution``: the utility of a coalition is
the test accuracy of its weighted aggregate), which needs the decoded
client models, as any server hook that reads them. With
``checkpoint_dir`` the round state (global model, server optimizer, the
DP counters, SCAFFOLD's and Mime's server trees) is saved after every
``checkpoint_frequency`` accepted rounds (``core/checkpoint``), and
``resume: true`` re-enters at the round after the newest restorable one.

Each round is traced as in the reference: the spans ``round/<n>/sample``,
``round/<n>/train`` (one ``round/<n>/client/<id>/train`` a client inside),
``round/<n>/aggregate`` and ``round/<n>/eval`` go to
``<log_file_dir>/run_<run_id>/spans.jsonl`` (service ``sp``), the profiler
events ``train`` and ``aggregate`` to ``events.jsonl``, and ``train()``
ends with ``telemetry.flush_run()``, so ``telemetry report`` reads the run
dir as soon as it returns; ``sys_perf_profiling: false`` turns the events
off. Spans never synchronise the card: their walls are host time.

Not ported yet, and refused when their arguments are set: FHE (ROADMAP
A13) and device trace capture (A12b). The ``sp/rounds`` counter and the
``sp/client_train_ms``, ``sp/encode_ms``, ``sp/screen_ms`` and
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
    requires_full_trees,
    tree_delta,
    tree_undelta,
)
from fedml_tpu_torch.core.alg_frame.params import Context
from fedml_tpu_torch.core.checkpoint import (
    apply_round_state,
    engine_checkpointer,
    pack_round_state,
    should_save,
)
from fedml_tpu_torch.core.contribution import ContributionAssessorManager
from fedml_tpu_torch.core.mlops.event import MLOpsProfilerEvent
from fedml_tpu_torch.core.security.defender import FedMLDefender
from fedml_tpu_torch.data.dataset import FederatedDataset
from fedml_tpu_torch.device import resolve_device
from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator
from fedml_tpu_torch.ml.aggregator.default_aggregator import create_server_aggregator
from fedml_tpu_torch.ml.aggregator.server_optimizer import ServerOptimizer
from fedml_tpu_torch.integrity import (
    AcceptanceGuard,
    IntegrityConfig,
    QuarantineList,
    UpdateScreen,
    parse_robust_spec,
    resolve_agg_robust,
)
from fedml_tpu_torch.ml.trainer.trainer_creator import create_model_trainer
from fedml_tpu_torch.models import model_hub
from fedml_tpu_torch.models.convert import from_reference_layout, to_reference_layout
from fedml_tpu_torch.simulation.sampling import sample_clients, sample_from_list
from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.registry import get_registry
from fedml_tpu_torch.telemetry.spans import configure_from_args, flush_run
from fedml_tpu_torch.utils.tree import (
    Tree,
    tree_add,
    tree_map,
    tree_scale,
    tree_stack,
    tree_zeros_like,
    weighted_tree_sum,
)

logger = logging.getLogger(__name__)

# arguments of features this engine does not have yet → the ROADMAP item
_NOT_PORTED = {
    "trace_rounds": "device trace capture (ROADMAP A12b)",
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
        self.event = MLOpsProfilerEvent(args)
        self.tracer = configure_from_args(args, service="sp")
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
        self._m_screen_ms = reg.histogram("sp/screen_ms")
        self._m_aggregate_ms = reg.histogram("sp/aggregate_ms")
        self._m_rounds = reg.counter("sp/rounds")
        self._codec = get_codec(getattr(args, "compression", ""), args)
        self._ef_by_client: Dict[int, ErrorFeedback] = {}

        # the integrity rings (parity: fedavg_api.py:101-136)
        self._agg_robust = resolve_agg_robust(args, codec=self._codec)
        if parse_robust_spec(getattr(args, "agg_robust", "")) is not None and (
                self._codec is None):
            raise ValueError(
                "agg_robust rides the compressed fused aggregation path; set "
                "compression (int8/bf16/identity), or use enable_defense + "
                "defense_type for uncompressed runs")
        icfg = IntegrityConfig.from_args(args)
        self._screen: Optional[UpdateScreen] = None
        self._quarantine: Optional[QuarantineList] = None
        self._guard: Optional[AcceptanceGuard] = None
        self._round_snapshot: Optional[dict] = None
        if icfg is not None:
            self._quarantine = QuarantineList(icfg.quarantine_rounds)
            if icfg.screen_enabled:
                self._screen = UpdateScreen(icfg.norm_mult, icfg.z_threshold)
            if icfg.rollback_enabled:
                self._guard = AcceptanceGuard(icfg.loss_mult, icfg.loss_min_history,
                                              icfg.max_rollbacks)

        self._contrib = ContributionAssessorManager(args)
        # round checkpoints and resume (parity: fedavg_api.py:139-146)
        self._ckpt = engine_checkpointer(args)
        self._start_round = 0
        if self._ckpt is not None and bool(getattr(args, "resume", False)):
            restored = self._ckpt.restore_latest(self._ckpt_state(), device=self.device)
            if restored is not None:
                self._apply_ckpt_state(restored[1])

    # -- the round state: checkpoints and ring 3's restore point ---------------
    def _ckpt_state(self) -> dict:
        """The packed round state (every round replaces these trees, never
        mutates them, so references suffice); an absent SCAFFOLD/Mime tree
        is saved as zeros with its flag off."""
        zeros = tree_zeros_like(self.global_params)
        return pack_round_state(
            self.global_params, self.server_opt, self._start_round, extra={
                "c_global": self._c_global if self._c_global is not None else zeros,
                "has_c": int(self._c_global is not None),
                "mime_s": self._mime_s if self._mime_s is not None else zeros,
                "has_mime": int(self._mime_s is not None)})

    def _apply_ckpt_state(self, state: dict) -> None:
        self.global_params = state["global_params"]
        # an absent tree restores to absent: a rollback of the first
        # SCAFFOLD/Mime round must drop the rejected round's fresh tree
        self._c_global = state["c_global"] if int(state["has_c"]) else None
        self._mime_s = state["mime_s"] if int(state["has_mime"]) else None
        self._start_round = apply_round_state(state, self.server_opt)

    def _assess_contributions(self, client_ids: List[int],
                              w_locals: List[Tuple[int, Tree]], round_idx: int) -> dict:
        """Each kept client's value this round (parity: fedavg_api.py:
        148-170); the utility is the test accuracy of a coalition's
        aggregate, v(∅) the round-open global model's."""
        if not self._contrib.is_enabled():
            return {}
        t0 = time.perf_counter()

        def util(params):
            return self.aggregator.test(params, self.dataset.test_data_global,
                                        self.device, self.args).get("test_acc", 0.0)

        values = self._contrib.run(client_ids, w_locals, util, util(self.global_params),
                                   round_idx)
        return {"contributions": values,
                "contribution_utility_calls": self._contrib.utility_calls + 1,
                "contribution_ms": (time.perf_counter() - t0) * 1e3}

    # -- client sampling (parity: fedavg_api.py:198-210) ---------------------
    def _client_sampling(self, round_idx: int) -> List[int]:
        if self._quarantine is not None:
            quarantined = set(self._quarantine.active(round_idx))
            if quarantined:
                allowed = [c for c in range(int(self.args.client_num_in_total))
                           if c not in quarantined]
                if not allowed:
                    raise RuntimeError(
                        "every client is quarantined; the federation has no "
                        "trustworthy cohort left (see the integrity/* counters)")
                return sample_from_list(
                    allowed, min(int(self.args.client_num_per_round), len(allowed)),
                    round_idx, int(getattr(self.args, "random_seed", 0)))
        return sample_clients(self.args, round_idx)

    def _drop_screened(self, cid: int, round_idx: int, reason: str) -> None:
        """A screened upload: its sender quarantined, its residual reset."""
        self._quarantine.quarantine(cid, round_idx, reason)
        self._ef_by_client.pop(cid, None)

    # -- compressed uplink simulation (parity: fedavg_api.py:224-292) ---------
    def _compress_uplinks(self, round_idx: int, client_ids: List[int],
                          w_locals: List[Tuple[int, Tree]], watches: Dict[str, _Stopwatch]):
        """Each client's update through the wire: its delta against the
        global model plus its error-feedback residual, encoded with
        ``derive_key(seed, round, client)`` in the reference's layout, then
        screened as encoded. Returns ``(w_kept, w_agg, kept, wire)``:
        ``w_agg`` is the fused aggregate, or None when a hook needs the
        decoded client models, which ``w_kept`` then holds."""
        seed = int(getattr(self.args, "random_seed", 0))
        kept = [True] * len(client_ids)
        enc = []  # (cid, position, n_k, ct)
        for i, (cid, (n_k, w)) in enumerate(zip(client_ids, w_locals)):
            started = watches["encode"].start()
            ef = self._ef_by_client.setdefault(cid, ErrorFeedback(self._codec))
            delta = to_reference_layout(tree_delta(w, self.global_params))
            ct = ef.encode(delta, key=derive_key(seed, round_idx, cid))
            watches["encode"].stop(started)
            if self._screen is not None:
                started = watches["screen"].start()
                reason = self._screen.admit(cid, round_idx, ct)
                watches["screen"].stop(started)
                if reason is not None:
                    kept[i] = False
                    self._drop_screened(cid, round_idx, reason)
                    continue
            enc.append((cid, i, n_k, ct))
        wire = [ct.wire_nbytes() for _, _, _, ct in enc]
        if self._screen is not None:
            flagged = self._screen.close_round(round_idx)
            for cid, i, _, _ in enc:
                if cid in flagged:
                    kept[i] = False
                    self._drop_screened(cid, round_idx, flagged[cid])
            enc = [e for e in enc if e[0] not in flagged]
        if not enc:
            raise RuntimeError(
                f"round {round_idx}: every upload was screened out — nothing "
                "trustworthy to aggregate (see the integrity/* counters)")
        pairs = [(n_k, ct) for _, _, n_k, ct in enc]
        w_kept = [w_locals[i] for _, i, _, _ in enc]
        started = watches["aggregate"].start()
        if not (requires_full_trees(self._codec, self.args)
                or self._contrib.is_enabled()):
            # a norm-only defense's clip factors come off the blocks; an
            # agg_robust spec swaps the weighted mean for the robust statistic
            clip = None if self._agg_robust else (
                FedMLDefender.get_instance().fused_clip_factors([ct for _, ct in pairs]))
            w_agg = from_reference_layout(FedMLAggOperator.agg_compressed(
                self.args, pairs, to_reference_layout(self.global_params),
                clip_factors=clip, agg_robust=self._agg_robust))
            watches["aggregate"].stop(started)
            return w_kept, w_agg, kept, wire
        decoded = [(n, tree_undelta(self.global_params,
                                    from_reference_layout(self._codec.decode(ct))))
                   for n, ct in pairs]
        watches["aggregate"].stop(started)
        return decoded, None, kept, wire

    def _screen_plain(self, round_idx: int, client_ids: List[int],
                      w_locals: List[Tuple[int, Tree]], watch: _Stopwatch):
        """Without a codec the raw displacement is screened against the
        round's global model (parity: fedavg_api.py:392-414)."""
        kept = [True] * len(client_ids)
        for i, (cid, (_, w)) in enumerate(zip(client_ids, w_locals)):
            started = watch.start()
            reason = self._screen.admit(cid, round_idx, w, base=self.global_params)
            watch.stop(started)
            if reason is not None:
                kept[i] = False
                self._quarantine.quarantine(cid, round_idx, reason)
        flagged = self._screen.close_round(round_idx)
        for i, cid in enumerate(client_ids):
            if cid in flagged:
                kept[i] = False
                self._quarantine.quarantine(cid, round_idx, flagged[cid])
        w_locals = [p for p, k in zip(w_locals, kept) if k]
        if not w_locals:
            raise RuntimeError(
                f"round {round_idx}: every upload was screened out — nothing "
                "trustworthy to aggregate (see the integrity/* counters)")
        return w_locals, kept

    # -- round ----------------------------------------------------------------
    def train_one_round(self, round_idx: int) -> dict:
        if self._guard is not None:
            # the round-open state: with checkpoint_frequency 1, exactly the
            # last checkpoint
            self._round_snapshot = self._ckpt_state()
        with self.tracer.span(f"round/{round_idx}/sample"):
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
        flight_recorder.record("round_start", round=round_idx,
                               clients=[int(c) for c in client_ids])
        self.event.log_event_started("train", round_idx)
        with self.tracer.span(f"round/{round_idx}/train"):
            for cid in client_ids:
                self.trainer.set_id(cid)
                self.trainer.set_round(round_idx)
                self.trainer.set_server_state(server_state)
                train_data = self.dataset.train_data_local_dict[cid]
                n_k = self.dataset.train_data_local_num_dict[cid]
                t0 = time.perf_counter()
                with self.tracer.span(f"round/{round_idx}/client/{cid}/train",
                                      n_samples=n_k):
                    w, metrics = self.trainer.run_local_training(
                        self.global_params, train_data, self.device, self.args)
                self._m_client_ms.observe((time.perf_counter() - t0) * 1e3)
                if metrics.get("scaffold_c_delta") is not None:
                    c_deltas.append(metrics["scaffold_c_delta"])
                if metrics.get("mime_full_grad") is not None:
                    mime_grads.append(metrics["mime_full_grad"])
                taus.append(float(metrics.get("local_steps", 0.0)))
                w_locals.append((n_k, w))
        self.event.log_event_ended("train", round_idx)

        self.event.log_event_started("aggregate", round_idx)
        agg_span = self.tracer.begin(f"round/{round_idx}/aggregate")
        watches = {k: _Stopwatch(self.device) for k in ("encode", "screen", "aggregate")}
        ctx.add("global_model_for_defense", self.global_params)
        w_agg, wire = None, None
        kept = [True] * len(client_ids)
        if self._codec is not None:
            w_locals, w_agg, kept, wire = self._compress_uplinks(
                round_idx, client_ids, w_locals, watches)
        elif self._screen is not None:
            w_locals, kept = self._screen_plain(round_idx, client_ids, w_locals,
                                                watches["screen"])
        if not all(kept):
            # screened clients' optimizer side channels drop with them
            taus = [t for t, k in zip(taus, kept) if k]
            if len(c_deltas) == len(kept):
                c_deltas = [c for c, k in zip(c_deltas, kept) if k]
            if len(mime_grads) == len(kept):
                mime_grads = [g for g, k in zip(mime_grads, kept) if k]
        if w_agg is None:
            started = watches["aggregate"].start()
            w_list, _ = self.aggregator.on_before_aggregation(w_locals)
            w_agg = self.aggregator.aggregate(w_list)
            w_agg = self.aggregator.on_after_aggregation(w_agg)
            watches["aggregate"].stop(started)
        # phi[i] pairs with the i-th KEPT client: the screened ones left
        # w_locals already
        contributions = self._assess_contributions(
            [c for c, k in zip(client_ids, kept) if k], w_locals, round_idx)
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
        self.tracer.end(agg_span)
        self.event.log_event_ended("aggregate", round_idx)
        self._m_rounds.inc()
        flight_recorder.record("round_end", round=round_idx)

        report: Dict[str, Any] = {"round": round_idx, "clients": client_ids,
                                  **contributions}
        freq = int(getattr(self.args, "frequency_of_the_test", 1))
        do_eval = (round_idx % max(freq, 1) == 0
                   or round_idx == int(self.args.comm_round) - 1)
        metrics = None
        if do_eval:
            with self.tracer.span(f"round/{round_idx}/eval"):
                metrics = self.aggregator.test(self.global_params,
                                               self.dataset.test_data_global,
                                               self.device, self.args)
        if self._codec is not None:
            report["encode_ms"] = watches["encode"].total_ms()
            self._m_encode_ms.observe(report["encode_ms"])
            report["uplink_bytes"] = wire
        if self._screen is not None:
            report["screen_ms"] = watches["screen"].total_ms()
            self._m_screen_ms.observe(report["screen_ms"])
        report["aggregate_ms"] = watches["aggregate"].total_ms()
        self._m_aggregate_ms.observe(report["aggregate_ms"])
        if self._guard is not None:
            # ring 3: non-finite params every round, the loss spike on eval
            # rounds
            loss = (metrics or {}).get("test_loss")
            reason = self._guard.check(self.global_params, loss)
            if reason is not None:
                return self._rollback_round(round_idx, reason, client_ids)
            self._guard.accept(loss)
        # after ring 3: a rejected round never becomes durable
        if self._ckpt is not None and should_save(self.args, round_idx):
            self._start_round = round_idx + 1
            t0 = time.perf_counter()
            self._ckpt.save(round_idx, self._ckpt_state())
            report["checkpoint_ms"] = (time.perf_counter() - t0) * 1e3
            report["checkpoint_bytes"] = self._ckpt.last_save_bytes
        if metrics is not None:
            report.update(metrics)
            self.test_history.append(report)
            logger.info("round %d acc=%.4f loss=%.4f", round_idx,
                        metrics.get("test_acc", -1), metrics.get("test_loss", -1))
        return report

    def _rollback_round(self, round_idx: int, reason: str,
                        client_ids: List[int]) -> dict:
        """Ring 3: the round was rejected — restore the round-open state,
        quarantine the suspects (ring 1's ranking, else the whole cohort,
        unless that would leave no cohort), reset the cohort's residuals,
        and have :meth:`train` re-run the round. Raises past the consecutive
        ``max_rollbacks`` budget."""
        self._guard.record_rollback(round_idx, reason)
        suspects = []
        if self._screen is not None:
            suspects = [c for c in self._screen.suspects() if c in client_ids]
        if not suspects:
            suspects = list(client_ids)
        if self._quarantine is not None:
            pool = self._quarantine.filter_selection(
                [c for c in range(int(self.args.client_num_in_total))
                 if c not in set(suspects)], round_idx)
            if pool:
                for cid in suspects:
                    self._quarantine.quarantine(
                        cid, round_idx, f"round {round_idx} rolled back: {reason}")
            else:
                logger.warning("rollback suspects %s cover every remaining client — "
                               "re-running unquarantined (bounded by max_rollbacks)",
                               suspects)
        for cid in client_ids:
            self._ef_by_client.pop(cid, None)
        self._apply_ckpt_state(self._round_snapshot)
        logger.warning("round %d rolled back (%s); suspects %s — re-running with a "
                       "fresh cohort", round_idx, reason, suspects)
        return {"round": round_idx, "clients": client_ids, "rolled_back": True,
                "reason": reason}

    def train(self) -> dict:
        t0 = time.time()
        round_idx = self._start_round
        while round_idx < int(self.args.comm_round):
            if self.train_one_round(round_idx).get("rolled_back"):
                continue  # the same round again, the quarantine applied
            round_idx += 1
        wall = time.time() - t0
        # every span and a registry snapshot land in the run dir, so
        # `telemetry report` reads it as soon as train() returns
        flush_run()
        self.event.flush()
        final = self.test_history[-1] if self.test_history else {}
        return {
            "wall_clock_sec": wall,
            "rounds": int(self.args.comm_round),
            "rounds_per_sec": int(self.args.comm_round) / max(wall, 1e-9),
            **final,
        }


__all__ = ["FedAvgAPI"]
