"""Cross-silo client FSM — counterpart of
``fedml_tpu/cross_silo/client/fedml_client_master_manager.py``: report
ONLINE on connection-ready, train on each init or sync, upload, stop on
finish.

The server's negotiation header (``MSG_ARG_KEY_COMPRESSION``) picks the
upload codec: the update is the delta against the broadcast as this client
decoded it, plus the error-feedback residual, encoded in the reference's
layout under ``derive_key(seed, round, rank)``, so the upload's wire arrays
are the ones a JAX client would send. Without a codec the trained model
goes up in the reference's message form (``models/convert.to_wire_params``).
A client that missed rounds, or is re-synced after an eviction, drops its
residual. Against the asynchronous server the round header is the model
version the server handed back, and the upload is tagged with it (its
staleness is the server's versions since). The upload and status messages
carry the reference's health fields (``ts``, ``mem_bytes`` from ``torch.cuda.memory_stats`` on the card,
``train_ms``, ``train_loss``), ``local_steps`` and the round as Python
numbers.

The client draws no global random state: its batches are seeded by (seed,
rank, round) and its codec keys by ``derive_key``, so clients training on
threads of one process stay deterministic. The trainer's trust hooks
(data poisoning, local DP) are keyed by this client's rank
(``ClientTrainer.trust_stream``), so in-process silos draw what each
silo's own process would. An ``agg_robust`` header is checked: a spec this
client cannot parse means the federation disagrees about its aggregation.

Under ``secagg: int8`` the client's X25519 key rides every status message,
each broadcast's secagg header opens the round's mask state (the header,
not the compression negotiation, sets the upload codec), the delta leaves
masked (``privacy/secagg``, in the reference's layout, keyed by
``derive_key(seed, round, rank)``), and the only thing the client ever
reveals is the pair seeds it shared with peers the server evicted. A client
with no open masked round refuses to upload. ``secure_aggregation: true``
selects the Bonawitz FSM instead (``cross_silo/secagg``, through the client
facade).

Each local training runs under ``round/<n>/client/<rank>/train``, inside
the ``comm/dispatch`` span that carries the server's round context, so it
stitches into the server's trace. A client in its own process (any
backend but LOCAL) binds the run dir's sinks itself, stamped
``rank<r>``, and lands its spans there at finish. The live telemetry
streamers come with ROADMAP A12c.
"""
from __future__ import annotations

import logging
import platform
import threading
import time
from typing import Any, Optional

import torch

from fedml_tpu_torch.compression import (
    CompressedTree,
    ErrorFeedback,
    derive_key,
    get_codec,
    tree_delta,
)
from fedml_tpu_torch.core.distributed.fedml_comm_manager import (
    COMM_BACKEND_LOCAL,
    FedMLCommManager,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.cross_silo.message_define import MyMessage
from fedml_tpu_torch.cross_silo.server.fedml_server_manager import refuse_unported
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.integrity import parse_robust_spec
from fedml_tpu_torch.models.convert import (
    from_reference_layout,
    from_wire_params,
    to_reference_layout,
    to_wire_params,
)
from fedml_tpu_torch.privacy.secagg import SecAggClientSession, SecAggMessage
from fedml_tpu_torch.telemetry.registry import get_registry
from fedml_tpu_torch.telemetry.spans import configure_from_args, flush_run, get_tracer
from fedml_tpu_torch.utils.tree import Tree

logger = logging.getLogger(__name__)

_NOT_PORTED = {
    "live_telemetry": "the live telemetry plane (ROADMAP A12c)",
}


class ClientMasterManager(FedMLCommManager):
    def __init__(self, args: Any, trainer_dist_adapter, comm=None, rank: int = 0,
                 size: int = 0, backend: str = COMM_BACKEND_LOCAL,
                 device: DeviceLike = "cpu"):
        refuse_unported(args, _NOT_PORTED)
        super().__init__(args, comm, rank, size, backend, device)
        # in process, the ranks share the server's tracer and run dir
        self._own_sinks = str(backend).upper() != COMM_BACKEND_LOCAL
        if self._own_sinks:
            configure_from_args(args, service=f"rank{self.rank}")
        self.trainer_dist_adapter = trainer_dist_adapter
        self.round_idx = 0
        self.has_sent_online_msg = False
        self._upload_codec = None
        self._error_feedback: Optional[ErrorFeedback] = None
        self._global_ref: Optional[Tree] = None
        self._last_train_ms: Optional[float] = None
        self._heartbeat_thread: Optional[threading.Thread] = None
        self._finished = threading.Event()
        self._secagg = SecAggClientSession.from_args(rank, args)

    def _heartbeat_fields(self) -> dict:
        """The reference's health scalars, piggybacked on status and upload
        messages."""
        hb = {"ts": time.time()}
        if self.device.type == "cuda":
            hb["mem_bytes"] = int(torch.cuda.memory_stats(self.device).get(
                "allocated_bytes.all.current", 0))
        if self._last_train_ms is not None:
            hb["train_ms"] = round(self._last_train_ms, 3)
        loss = self.trainer_dist_adapter.last_train_metrics.get("train_loss")
        if isinstance(loss, (int, float)):
            hb["train_loss"] = float(loss)
        return hb

    def register_message_receive_handlers(self) -> None:
        for msg_type, handler in (
                (MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_message_connection_ready),
                (MyMessage.MSG_TYPE_S2C_CHECK_CLIENT_STATUS, self.handle_message_check_status),
                (MyMessage.MSG_TYPE_S2C_INIT_CONFIG, self.handle_message_init),
                (MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT,
                 self.handle_message_receive_model_from_server),
                (MyMessage.MSG_TYPE_S2C_FINISH, self.handle_message_finish),
                (MyMessage.MSG_TYPE_S2C_REJOIN_SYNC, self.handle_message_rejoin_sync),
                (SecAggMessage.MSG_TYPE_S2C_SECAGG_RECOVER,
                 self.handle_message_secagg_recover)):
            self.register_message_receive_handler(msg_type, handler)

    # -- handlers -------------------------------------------------------------
    def handle_message_connection_ready(self, msg: Message) -> None:
        if not self.has_sent_online_msg:
            self.has_sent_online_msg = True
            self.send_client_status(0)
            self._start_heartbeat()

    def _start_heartbeat(self) -> None:
        """A periodic status (``heartbeat_interval_s`` > 0): keeps the
        server's last-seen fresh through long local epochs, and is this
        client's way back in after a partition heals."""
        interval = self.resilience.heartbeat_interval_s
        if interval <= 0 or self._heartbeat_thread is not None:
            return

        def beat() -> None:
            m_sent = get_registry().counter("resilience/heartbeats_sent")
            while not self._finished.wait(interval):
                try:
                    self.send_client_status(0)
                    m_sent.inc()
                except OSError:
                    logger.debug("heartbeat send failed (transport down?)", exc_info=True)

        self._heartbeat_thread = threading.Thread(target=beat, name=f"heartbeat-{self.rank}",
                                                  daemon=True)
        self._heartbeat_thread.start()

    def handle_message_check_status(self, msg: Message) -> None:
        self.send_client_status(msg.get_sender_id())

    def _receive_global_model(self, msg: Message) -> Tree:
        """The broadcast as a port tree on this client's device, and the
        codec negotiation."""
        payload = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        if isinstance(payload, CompressedTree):
            decoded = get_codec(payload.codec).decode(payload)
            global_params = {k: v.to(self.device) for k, v in
                             from_reference_layout(decoded).items()}
        else:
            global_params = from_wire_params(payload, self.device)
        if self._secagg is not None:
            header = msg.get(SecAggMessage.MSG_ARG_KEY_SECAGG)
            if header is not None:
                # the header rules the upload wire; the compression
                # negotiation applies to the broadcast only
                self._secagg.begin_round(header, int(msg.get(MyMessage.MSG_ARG_KEY_ROUND, 0)))
            self._global_ref = global_params
            return global_params
        robust = msg.get(Message.MSG_ARG_KEY_AGG_ROBUST)
        if robust is not None:
            # informational for a flat client (the server aggregates), but an
            # unparsable spec must fail loudly
            parse_robust_spec(robust)
        negotiated = msg.get(Message.MSG_ARG_KEY_COMPRESSION)
        if negotiated is not None:
            # the server's spec wins over local config, so every peer encodes
            # blocks the fused aggregation can stack (instances are cached
            # per spec: identity is equality)
            codec = get_codec(negotiated, self.args)
            if codec is not None and codec is not self._upload_codec:
                self._upload_codec = codec
                self._error_feedback = ErrorFeedback(codec)
        self._global_ref = global_params
        return global_params

    def handle_message_init(self, msg: Message) -> None:
        global_params = self._receive_global_model(msg)
        self.round_idx = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND, 0))
        self.trainer_dist_adapter.update_dataset(int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)))
        self._train(global_params)

    def handle_message_receive_model_from_server(self, msg: Message) -> None:
        new_round = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx + 1))
        if new_round > self.round_idx + 1 and (self._error_feedback is not None
                                               or self._secagg is not None):
            # rounds were missed without a rejoin resync: the residual belongs
            # to a stale global model and would leak pre-gap error
            logger.info("client %d skipped rounds %d..%d; resetting EF", self.rank,
                        self.round_idx + 1, new_round - 1)
            if self._error_feedback is not None:
                self._error_feedback.reset()
            if self._secagg is not None:
                self._secagg.reset_identity()
        global_params = self._receive_global_model(msg)
        self.round_idx = new_round
        self.trainer_dist_adapter.update_dataset(int(msg.get(MyMessage.MSG_ARG_KEY_CLIENT_INDEX)))
        self._train(global_params)

    def handle_message_rejoin_sync(self, msg: Message) -> None:
        """The server re-admitted this client: catch up to the current round
        and model without training, and drop the error-feedback residual of
        the client's life before the eviction."""
        self._receive_global_model(msg)
        self.round_idx = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND, self.round_idx))
        if self._error_feedback is not None:
            self._error_feedback.reset()
        if self._secagg is not None:
            self._secagg.reset_identity()
        get_registry().counter("resilience/rejoin_syncs").inc()
        logger.info("client %d re-synced at round %d after rejoin", self.rank, self.round_idx)

    def handle_message_finish(self, msg: Message) -> None:
        self.finish()

    def finish(self) -> None:
        self._finished.set()  # stops the heartbeat on every shutdown path
        if self._own_sinks:
            try:
                flush_run()
            except OSError:  # observability never breaks shutdown
                logger.exception("telemetry flush failed at finish")
        super().finish()

    # -- actions --------------------------------------------------------------
    def send_client_status(self, receive_id: int, status: Optional[str] = None) -> None:
        msg = Message(MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.get_sender_id(), receive_id)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_STATUS,
                       status or MyMessage.MSG_CLIENT_STATUS_IDLE)
        msg.add_params(MyMessage.MSG_ARG_KEY_CLIENT_OS, platform.system())
        msg.add_params(Message.MSG_ARG_KEY_HEALTH, self._heartbeat_fields())
        if self._secagg is not None:
            # the key advertisement: 32 bytes on a message already sent
            msg.add_params(SecAggMessage.MSG_ARG_KEY_SECAGG_PK, self._secagg.pk)
        self.send_message(msg)

    def handle_message_secagg_recover(self, msg: Message) -> None:
        """Dropout recovery: reveal the pair seeds shared with the evicted
        peers, and only those; a refused request goes unanswered, which the
        server's bounded recovery deadline treats as this client's dropout."""
        if self._secagg is None:
            return
        seeds = self._secagg.reveal_for(
            msg.get(SecAggMessage.MSG_ARG_KEY_SECAGG_EVICTED) or [],
            msg.get(MyMessage.MSG_ARG_KEY_ROUND))
        if seeds is None:
            return
        m = Message(SecAggMessage.MSG_TYPE_C2S_SECAGG_REVEAL, self.get_sender_id(),
                    msg.get_sender_id())
        m.add_params(SecAggMessage.MSG_ARG_KEY_SECAGG_REVEAL, seeds)
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND, msg.get(MyMessage.MSG_ARG_KEY_ROUND))
        self.send_message(m)

    def _encode_update(self, weights: Tree):
        """The upload: masked under secagg, else through the negotiated codec
        (the delta against the decoded broadcast with error feedback), else
        the model itself."""
        if self._secagg is not None:
            if not self._secagg.active or self._global_ref is None:
                raise ValueError(f"client {self.rank} has no open secagg round to encode "
                                 "into — refusing to upload an unmasked model")
            delta = to_reference_layout(tree_delta(weights, self._global_ref))
            return self._secagg.encode_update(
                delta, derive_key(int(getattr(self.args, "random_seed", 0)),
                                  self.round_idx, self.rank))
        if self._upload_codec is None or self._global_ref is None:
            return to_wire_params(weights)
        delta = to_reference_layout(tree_delta(weights, self._global_ref))
        key = derive_key(int(getattr(self.args, "random_seed", 0)), self.round_idx, self.rank)
        return self._error_feedback.encode(delta, key=key)

    def send_model_to_server(self, receive_id: int, weights: Tree,
                             local_sample_num: int) -> None:
        msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.get_sender_id(),
                      receive_id)
        msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, self._encode_update(weights))
        msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, int(local_sample_num))
        # the model version the update came from
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, int(self.round_idx))
        steps = self.trainer_dist_adapter.last_train_metrics.get("local_steps")
        if steps is not None:  # FedNova's tau_i
            msg.add_params("local_steps", float(steps))
        msg.add_params(Message.MSG_ARG_KEY_HEALTH, self._heartbeat_fields())
        self.send_message(msg)

    def _train(self, global_params: Tree) -> None:
        t0 = time.perf_counter()
        with get_tracer().span(f"round/{self.round_idx}/client/{self.rank}/train"):
            weights, local_sample_num = self.trainer_dist_adapter.train(self.round_idx,
                                                                        global_params)
        self._last_train_ms = (time.perf_counter() - t0) * 1e3
        self.send_model_to_server(0, weights, local_sample_num)
