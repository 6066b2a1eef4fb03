"""Cross-silo server FSM — counterpart of
``fedml_tpu/cross_silo/server/fedml_server_manager.py``, its synchronous
path: wait for every client's ONLINE status → broadcast the round's model
→ collect uploads → aggregate, test, select the next cohort → sync or
finish.

The messages are the reference's, so a JAX client can join a port server.
An uncompressed model crosses a message in the reference's form (nested,
in its layout: ``models/convert.to_wire_params``) and is converted back on
receipt, on LOCAL as on BROKER. Under a broadcast-safe codec the broadcast
is encoded once and fanned out, and under a lossy one the clients' deltas
resolve against the broadcast as they decoded it.

With ``round_deadline_s`` a dead client cannot hang a round: the deadline
(the static ceiling, tightened by the clients' latency EWMAs once they
exist) closes the round on a quorum of uploads, evicts the missing clients
and probes them each round; a returning client is re-synced and re-enters
at the next selection. A round stuck below quorum re-arms a bounded number
of times, then aborts the federation through ``handler_error``.

Not ported yet, and refused when their arguments are set: secure
aggregation, the integrity rings, robust aggregation and the rest of the
trust stack (ROADMAP A10.2), the durability journal and chaos (A10.3),
round checkpoints and resume (A4), and the live telemetry plane, spans and
the flight recorder (A12). ``cross_silo/round_ms`` (broadcast to the test
after aggregation) and the reference's ``resilience/*`` counters go to the
port's metrics registry.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.compression import CompressedTree, check_trust_stack, derive_key, get_codec
from fedml_tpu_torch.core.distributed.fedml_comm_manager import (
    COMM_BACKEND_LOCAL,
    FedMLCommManager,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.cross_silo.message_define import MyMessage
from fedml_tpu_torch.cross_silo.server.fedml_aggregator import FedMLAggregator
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.models.convert import (
    from_reference_layout,
    from_wire_params,
    to_reference_layout,
    to_wire_params,
)
from fedml_tpu_torch.resilience import (
    RoundDeadline,
    ServerKillWindow,
    adaptive_deadline_s,
    journal_from_args,
    quorum_size,
)
from fedml_tpu_torch.telemetry import get_registry

logger = logging.getLogger(__name__)

# arguments of features the port's server does not have yet → the item
_NOT_PORTED = {
    "secure_aggregation": "secure aggregation (ROADMAP A10.2)",
    "resume": "resume from a round checkpoint (ROADMAP A4)",
    "checkpoint_dir": "round checkpoints (ROADMAP A4)",
    "live_telemetry": "the live telemetry plane (ROADMAP A12)",
}


def refuse_unported(args: Any, table: Dict[str, str]) -> None:
    check_trust_stack(args)
    for arg, what in table.items():
        if getattr(args, arg, None):
            raise NotImplementedError(
                f"{arg}: {what} is not ported to the cross-silo path yet")


class _LatencyEWMA:
    """Each client's round latency (broadcast to upload) as an EWMA, folded
    when a round closes: the part of the reference's ``ClientHealthTracker``
    that the adaptive deadline reads (its scores are the telemetry stack's,
    ROADMAP A12)."""

    def __init__(self, alpha: float = 0.4):
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        self._pending: Dict[int, Dict[int, float]] = {}
        self.ewma: Dict[int, float] = {}

    def observe(self, client_id: int, round_idx: int, latency_s: float) -> None:
        if math.isfinite(latency_s):
            with self._lock:
                self._pending.setdefault(int(round_idx), {})[client_id] = float(latency_s)

    def finish_round(self, round_idx: int) -> None:
        with self._lock:
            for cid, lat in self._pending.pop(int(round_idx), {}).items():
                prev = self.ewma.get(cid)
                self.ewma[cid] = lat if prev is None else (
                    self.alpha * lat + (1 - self.alpha) * prev)

    def snapshot(self) -> Dict[int, float]:
        with self._lock:
            return dict(self.ewma)


class FedMLServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator: FedMLAggregator, comm=None,
                 client_rank: int = 0, client_num: int = 0,
                 backend: str = COMM_BACKEND_LOCAL, device: DeviceLike = "cpu"):
        refuse_unported(args, _NOT_PORTED)
        journal_from_args(args)
        ServerKillWindow.from_args(args)
        super().__init__(args, comm, client_rank, client_num + 1, backend, device)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 1))
        self.args.round_idx = 0
        self.client_num = client_num
        self.client_online_status: Dict[int, bool] = {}
        self.client_id_list_in_this_round: Optional[List[int]] = None
        self.data_silo_index_of_client: Dict[int, int] = {}
        self.is_initialized = False
        self.result: Optional[dict] = None
        # the broadcast goes through the configured codec and the spec rides
        # every round config, so clients upload delta-encoded updates
        self._codec = get_codec(getattr(args, "compression", ""), args)
        self._latency = _LatencyEWMA()
        self._bcast_ts: Dict[int, float] = {}
        self._round_t0 = 0.0
        self._round_lock = threading.Lock()
        self._round_closed = False
        self._deadline_expired = False
        self._deadline_extensions_used = 0
        self._completing = False
        self._finished_once = False
        self._deadline = RoundDeadline(self._on_round_deadline)
        self._m_round_ms = get_registry().histogram("cross_silo/round_ms")

    # -- broadcast ------------------------------------------------------------
    def _broadcast_payload(self, global_params):
        """The round's broadcast, encoded once and fanned out to the cohort."""
        if self._codec is None or not self._codec.broadcast_safe:
            # an upload-only codec (topk) rides the negotiation header only
            self.aggregator.set_delta_base(None)
            return to_wire_params(global_params)
        # rank 0's key slot: clients encode uploads under their own ranks
        ct = self._codec.encode(
            to_reference_layout(global_params),
            key=derive_key(int(getattr(self.args, "random_seed", 0)),
                           int(self.args.round_idx), 0))
        # clients delta against the broadcast as they decode it; the server
        # resolves against the same base, or the broadcast's quantization
        # error would leak into every aggregate
        self.aggregator.set_delta_base(
            None if self._codec.lossless else from_reference_layout(self._codec.decode(ct)))
        return ct

    def _send_round_config(self, client_ids: List[int], payload, init: bool) -> None:
        msg_type = (MyMessage.MSG_TYPE_S2C_INIT_CONFIG if init
                    else MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)
        for client_id in client_ids:
            msg = Message(msg_type, self.get_sender_id(), client_id)
            msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, payload)
            msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX,
                           int(self.data_silo_index_of_client[client_id]))
            msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, int(self.args.round_idx))
            if self._codec is not None:
                msg.add_params(Message.MSG_ARG_KEY_COMPRESSION, self._codec.spec)
            self._bcast_ts[client_id] = time.time()
            self.send_message(msg)

    def _open_round(self, global_params, init: bool) -> None:
        """Broadcast the current round to its cohort and arm its deadline."""
        self._round_t0 = time.perf_counter()
        payload = self._broadcast_payload(global_params)
        with self._round_lock:
            self._round_closed = False
            self._deadline_expired = False
            self._deadline_extensions_used = 0
            self._completing = False
            cohort = list(self.client_id_list_in_this_round)
        self._send_round_config(cohort, payload, init)
        self._arm_round_deadline()

    def send_init_msg(self) -> None:
        self._open_round(self.aggregator.get_global_model_params(), init=True)

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_message_connection_ready)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_message_client_status_update)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER,
            self.handle_message_receive_model_from_client)

    # -- handlers -------------------------------------------------------------
    def handle_message_connection_ready(self, msg: Message) -> None:
        if self.is_initialized:
            return
        for client_id in range(1, self.client_num + 1):  # the liveness handshake
            self.send_message(Message(MyMessage.MSG_TYPE_S2C_CHECK_CLIENT_STATUS,
                                      self.get_sender_id(), client_id))

    def handle_message_client_status_update(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        # any sign of life from an evicted client is its reconnect
        if self.is_initialized and self.liveness.is_evicted(sender):
            self._readmit_client(sender)
            return
        if msg.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS) == MyMessage.MSG_CLIENT_STATUS_IDLE:
            self.client_online_status[sender] = True
        all_online = all(self.client_online_status.get(cid, False)
                         for cid in range(1, self.client_num + 1))
        if all_online and not self.is_initialized:
            self.is_initialized = True
            self._select_round_clients()
            self.send_init_msg()

    def _select_round_clients(self) -> None:
        client_ids = list(range(1, self.client_num + 1))
        # evicted clients sit out until they rejoin; each round probes them,
        # so a revived client has a deterministic way back in
        evicted = set(self.liveness.evicted())
        if evicted:
            client_ids = [c for c in client_ids if c not in evicted]
            if not client_ids:
                raise RuntimeError("every client is evicted; the federation cannot "
                                   "make progress (check round_deadline_s)")
            self._probe_evicted(sorted(evicted))
        cohort = self.aggregator.client_selection(
            self.args.round_idx, client_ids,
            min(int(self.args.client_num_per_round), len(client_ids)))
        silo_indexes = self.aggregator.data_silo_selection(
            self.args.round_idx, int(self.args.client_num_in_total), len(cohort))
        # this can run on the deadline's timer thread while the receive
        # thread reads the cohort: both fields change under the round lock
        with self._round_lock:
            self.client_id_list_in_this_round = cohort
            self.data_silo_index_of_client = dict(zip(cohort, silo_indexes))

    def handle_message_receive_model_from_client(self, msg: Message) -> None:
        sender = msg.get_sender_id()
        model_params = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        msg_round = msg.get(MyMessage.MSG_ARG_KEY_ROUND)
        missing = None
        with self._round_lock:
            cohort = list(self.client_id_list_in_this_round or [])
            stale = (self._round_closed or sender not in cohort
                     or (msg_round is not None
                         and int(msg_round) != int(self.args.round_idx)))
            if not stale:
                if not isinstance(model_params, CompressedTree):
                    model_params = from_wire_params(model_params, self.device)
                sent = self._bcast_ts.get(sender)
                if sent:
                    self._latency.observe(sender, self.args.round_idx, time.time() - sent)
                self.aggregator.add_local_trained_result(
                    cohort.index(sender), model_params,
                    msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES),
                    local_steps=msg.get("local_steps"))
                missing = self._try_close_round(cohort)
        if stale:
            # a closed round's upload, or one from outside the cohort: never
            # applied; from an evicted client it is also its sign of life
            get_registry().counter("resilience/stale_uploads").inc()
            logger.warning("dropping stale upload from client %s (round %s, server at "
                           "round %s)", sender, msg_round, self.args.round_idx)
            if self.liveness.is_evicted(sender):
                self._readmit_client(sender)
            return
        if missing is not None:
            self._finish_round(missing)

    def _try_close_round(self, cohort: List[int]) -> Optional[List[int]]:
        """Under the round lock: close the round if every upload arrived, or
        the deadline expired with a quorum in. Returns the missing cohort
        ids once closed, else None."""
        expected = len(cohort)
        received = self.aggregator.n_received()
        if received < expected and not (
                self._deadline_expired
                and received >= quorum_size(expected, self.resilience.round_quorum)):
            return None
        missing_idx = self.aggregator.close_round_quorum(expected)
        self._round_closed = True
        self._deadline.cancel()
        return [cohort[i] for i in missing_idx]

    def _on_round_deadline(self, round_idx: int) -> None:
        """Timer thread: the armed round ran out of time."""
        with self._round_lock:
            if (self._round_closed or not self.is_initialized
                    or int(round_idx) != int(self.args.round_idx)):
                return  # the round closed normally
            self._deadline_expired = True
            cohort = list(self.client_id_list_in_this_round or [])
            missing = self._try_close_round(cohort)
            received = self.aggregator.n_received()
            extended = False
            if missing is None:
                # below quorum: a later upload that reaches quorum closes the
                # round, but a federation that never does must not wait
                # forever: a bounded number of re-arms, then abort. Re-armed
                # under the lock, so it cannot cancel the next round's timer.
                self._deadline_extensions_used += 1
                extended = (self._deadline_extensions_used
                            <= self.resilience.deadline_extensions)
                if extended:
                    self._deadline.arm(round_idx, self.resilience.round_deadline_s)
        need = quorum_size(len(cohort), self.resilience.round_quorum)
        get_registry().counter("resilience/deadline_fired").inc()
        if missing is None:
            if extended:
                logger.warning("round %d deadline expired with %d/%d uploads (< quorum "
                               "%d); extension %d/%d armed", round_idx, received,
                               len(cohort), need, self._deadline_extensions_used,
                               self.resilience.deadline_extensions)
                return
            self._abort_federation(
                f"round {round_idx} stuck below quorum: {received}/{len(cohort)} uploads "
                f"after {self.resilience.deadline_extensions} deadline extensions "
                f"(need {need})")
            return
        logger.warning("round %d closing on quorum: %d/%d uploads, missing %s",
                       round_idx, received, len(cohort), missing)
        # no receive loop wraps the timer thread: a failure here must fail
        # the federation, not vanish into threading's excepthook
        try:
            self._finish_round(missing)
        except BaseException as e:  # noqa: BLE001 - surfaced through handler_error
            logger.exception("round advance failed on the deadline path")
            self._abort_federation(f"round advance failed after quorum close: {e!r}")

    def _abort_federation(self, reason: str) -> None:
        """An unrecoverable stall becomes a loud failure: ``handler_error``
        (which the in-process harness and any supervisor watch) and a
        stopped receive loop."""
        logger.error("aborting federation: %s", reason)
        get_registry().counter("resilience/aborts").inc()
        with self._round_lock:
            self.handler_error = RuntimeError(reason)
        self.com_manager.stop_receive_message()

    def _finish_round(self, missing_clients: List[int]) -> None:
        """Evict the clients that missed the round, then aggregate."""
        reg = get_registry()
        if missing_clients:
            reg.counter("resilience/quorum_rounds").inc()
            for cid in missing_clients:
                if self.liveness.evict(cid):
                    reg.counter("resilience/clients_evicted").inc()
        self._complete_round()

    def _complete_round(self) -> None:
        with self._round_lock:
            if self._completing:
                return
            self._completing = True
        global_params = self.aggregator.aggregate()
        self._latency.finish_round(self.args.round_idx)
        metrics = self.aggregator.test_on_server_for_all_clients(self.args.round_idx)
        self._m_round_ms.observe((time.perf_counter() - self._round_t0) * 1e3)
        self.args.round_idx += 1
        if self.args.round_idx >= self.round_num:
            # the last close can come from the receive thread (all uploads
            # in) or the timer thread (quorum): the result under the lock
            with self._round_lock:
                self.result = {"rounds": self.round_num, **metrics}
            self._send_finish()
            self.finish()
            return
        self._select_round_clients()
        self._open_round(global_params, init=False)

    # -- resilience -----------------------------------------------------------
    def _probe_evicted(self, client_ids: List[int]) -> None:
        """Status probes to evicted peers, off-thread and failure-tolerant:
        the round must not stall on the clients it is probing for."""

        def probe() -> None:
            for cid in client_ids:
                try:
                    self.send_message(Message(MyMessage.MSG_TYPE_S2C_CHECK_CLIENT_STATUS,
                                              self.get_sender_id(), cid))
                except OSError:
                    logger.debug("probe to evicted client %s failed", cid, exc_info=True)

        threading.Thread(target=probe, name="evicted-probe", daemon=True).start()

    def _arm_round_deadline(self) -> None:
        cfg = self.resilience
        if not cfg.deadline_enabled:
            return
        timeout = cfg.round_deadline_s
        if cfg.deadline_adaptive:
            # no history → the static ceiling, so a cold first round never
            # fires early
            timeout = adaptive_deadline_s(self._latency.snapshot(), cfg.deadline_multiplier,
                                          cfg.deadline_grace_s, cfg.deadline_min_s,
                                          cfg.round_deadline_s)
        self._deadline.arm(int(self.args.round_idx), timeout)

    def _readmit_client(self, client_id: int) -> None:
        """An evicted client reconnected: re-sync it with the current round
        and model (uncompressed, so the in-flight round's delta base stays),
        marked as a rejoin so it resets its error feedback. It re-enters the
        cohort at the next selection."""
        if not self.liveness.readmit(client_id):
            return
        get_registry().counter("resilience/clients_rejoined").inc()
        logger.info("client %s rejoined at round %s", client_id, self.args.round_idx)
        m = Message(MyMessage.MSG_TYPE_S2C_REJOIN_SYNC, self.get_sender_id(), client_id)
        m.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                     to_wire_params(self.aggregator.get_global_model_params()))
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND, int(self.args.round_idx))
        m.add_params(Message.MSG_ARG_KEY_REJOIN, True)
        if self._codec is not None:
            m.add_params(Message.MSG_ARG_KEY_COMPRESSION, self._codec.spec)
        self.send_message(m)

    def _send_finish(self) -> None:
        for client_id in range(1, self.client_num + 1):
            self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH,
                                      self.get_sender_id(), client_id))

    def finish(self) -> None:
        with self._round_lock:
            if self._finished_once:
                return
            self._finished_once = True
        self._deadline.cancel()
        super().finish()
