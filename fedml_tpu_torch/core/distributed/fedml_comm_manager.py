"""FedMLCommManager — counterpart of
``fedml_tpu/core/distributed/fedml_comm_manager.py``: a registry of
``msg_type → handler`` callbacks observing a pluggable transport.

It stamps every outgoing message with a unique id, drops duplicates on
receipt (so a resend is applied once), retries a send under the seeded
backoff, notes every sender's liveness, and records a raising handler in
``handler_error`` and stops its receive loop, so a federation fails loudly
instead of hanging. The transports are ``LOCAL`` (in-process) and
``BROKER`` (TCP pub/sub with the object-store offload). ``GRPC``, ``TRPC``
and ``MQTT_S3`` come with ROADMAP A10.4 and ``XLA_ICI``'s device
collectives with the multi-GPU layer (A11): naming one raises. Spans, the
flight recorder and the live telemetry plane are A12's; the registry
counters keep the reference's names.
"""
from __future__ import annotations

import logging
import threading
from itertools import count
from typing import Any, Callable, Dict, Optional
from uuid import uuid4

import torch

from fedml_tpu_torch.core.distributed.communication.base_com_manager import (
    BaseCommunicationManager,
    Observer,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.resilience import (
    MessageDeduper,
    PeerLiveness,
    ResilienceConfig,
    chaos_from_args,
    transient_exceptions,
)
from fedml_tpu_torch.telemetry import get_registry

logger = logging.getLogger(__name__)

COMM_BACKEND_LOCAL = "LOCAL"
COMM_BACKEND_BROKER = "BROKER"
# backends of the reference the port does not have yet → the ROADMAP item
_NOT_PORTED_BACKENDS = {
    "GRPC": "ROADMAP A10.4",
    "TRPC": "ROADMAP A10.4",
    "MQTT_S3": "ROADMAP A10.4",
    "XLA_ICI": "the multi-GPU layer, ROADMAP A11",
}


class FedMLCommManager(Observer):
    MSG_TYPE_CONNECTION_IS_READY = "MSG_TYPE_CONNECTION_IS_READY"

    def __init__(self, args: Any, comm: Any = None, rank: int = 0, size: int = 0,
                 backend: str = COMM_BACKEND_LOCAL, device: DeviceLike = "cpu"):
        self.args = args
        self.size = int(size)
        self.rank = int(rank)
        self.backend = backend
        self.device = torch.device(device)
        self.com_manager: Optional[BaseCommunicationManager] = comm
        self.message_handler_dict: Dict[str, Callable] = {}
        self._receive_thread: Optional[threading.Thread] = None
        self.handler_error: Optional[BaseException] = None
        self.resilience = ResilienceConfig(args)
        chaos_from_args(args)
        # itertools.count is atomic under the GIL: the deadline timer, the
        # heartbeat and the receive thread all send
        self._msg_id_prefix = f"{uuid4().hex[:8]}:{self.rank}:"
        self._send_seq = count(1)
        self._deduper = MessageDeduper()
        self.liveness = PeerLiveness(
            silent_after_s=max(30.0, 3 * self.resilience.heartbeat_interval_s))
        self._send_retry = self.resilience.retry_policy(key=f"rank{rank}")
        self._retry_on = transient_exceptions()
        reg = get_registry()
        self._m_sent = reg.counter("comm/messages_sent",
                                   labels={"backend": str(backend).lower()})
        self._m_raw = reg.counter("comm/raw_bytes")
        self._m_dups = reg.counter("resilience/duplicates_dropped")
        self._m_retries = reg.counter("resilience/send_retries")
        self._m_failures = reg.counter("resilience/send_failures")
        if self.com_manager is None:
            self._init_manager()
        self.com_manager.add_observer(self)

    def run(self) -> None:
        self.register_message_receive_handlers()
        self._notify_connection_ready()
        self.com_manager.handle_receive_message()

    def run_async(self) -> threading.Thread:
        """Run the receive loop on a daemon thread (in-process federation)."""
        self.register_message_receive_handlers()
        t = threading.Thread(target=self.com_manager.handle_receive_message,
                             name=f"rank{self.rank}-recv", daemon=True)
        t.start()
        self._receive_thread = t
        return t

    def _notify_connection_ready(self) -> None:
        """On a distributed backend each rank kicks its own FSM with
        CONNECTION_IS_READY; the in-process harness posts it to every rank
        once all are up."""
        if str(self.backend).upper() == COMM_BACKEND_BROKER:
            self.receive_message(
                self.MSG_TYPE_CONNECTION_IS_READY,
                Message(self.MSG_TYPE_CONNECTION_IS_READY, self.rank, self.rank))

    def get_sender_id(self) -> int:
        return self.rank

    def receive_message(self, msg_type: str, msg_params: Message) -> None:
        msg_id = msg_params.get(Message.MSG_ARG_KEY_MSG_ID)
        if msg_id is not None and self._deduper.seen(msg_id):
            self._m_dups.inc()
            logger.debug("rank %d: duplicate %s dropped (%s)", self.rank, msg_type, msg_id)
            return
        self.liveness.note(msg_params.get_sender_id())
        handler = self.message_handler_dict.get(str(msg_type))
        if handler is None:
            logger.warning("rank %d: no handler for %s", self.rank, msg_type)
            return
        try:
            handler(msg_params)
        except BaseException as e:
            # a raising handler must not silently kill the receive thread
            # and hang the federation: record it and stop this rank's loop
            self.handler_error = e
            logger.exception("rank %d: handler for %s raised; stopping receive loop",
                             self.rank, msg_type)
            self.com_manager.stop_receive_message()

    def send_message(self, message: Message) -> None:
        # stamped once per logical message: a retried send keeps its id, so
        # the receiver drops the copy if the first attempt did land
        if message.get(Message.MSG_ARG_KEY_MSG_ID) is None:
            message.add_params(Message.MSG_ARG_KEY_MSG_ID,
                               self._msg_id_prefix + str(next(self._send_seq)))
        self._m_sent.inc()
        payload = message.get(Message.MSG_ARG_KEY_MODEL_PARAMS)
        if payload is not None:
            from fedml_tpu_torch.compression import CompressedTree
            from fedml_tpu_torch.utils.serialization import tree_nbytes

            self._m_raw.inc(payload.raw_nbytes if isinstance(payload, CompressedTree)
                            else tree_nbytes(payload))

        def on_retry(attempt: int, exc: BaseException) -> None:
            self._m_retries.inc()

        try:
            self._send_retry.call(lambda: self.com_manager.send_message(message),
                                  retry_on=self._retry_on, on_retry=on_retry)
        except self._retry_on:
            self._m_failures.inc()
            raise

    def register_message_receive_handler(self, msg_type: str, handler: Callable) -> None:
        self.message_handler_dict[str(msg_type)] = handler

    def register_message_receive_handlers(self) -> None:
        """Subclasses register their FSM handlers here."""

    def finish(self) -> None:
        self.com_manager.stop_receive_message()

    def _init_manager(self) -> None:
        backend = str(self.backend).upper()
        run_id = str(getattr(self.args, "run_id", "0"))
        if backend == COMM_BACKEND_LOCAL:
            from fedml_tpu_torch.core.distributed.communication.local_comm import (
                LocalCommManager,
            )

            self.com_manager = LocalCommManager(run_id, self.rank)
        elif backend == COMM_BACKEND_BROKER:
            from fedml_tpu_torch.core.distributed.communication.broker_comm import (
                BrokerCommManager,
            )
            from fedml_tpu_torch.core.distributed.communication.object_store import (
                create_object_store,
            )

            protocol = str(getattr(self.args, "broker_protocol", "tcp"))
            if protocol != "tcp":
                raise NotImplementedError(
                    f"broker_protocol {protocol!r}: the MQTT client comes with "
                    "ROADMAP A10.4; the port speaks the in-tree TCP broker")
            self.com_manager = BrokerCommManager(
                run_id, self.rank,
                host=str(getattr(self.args, "broker_host", "127.0.0.1")),
                port=int(getattr(self.args, "broker_port", 1883)),
                object_store=create_object_store(self.args),
                offload_bytes=int(getattr(self.args, "payload_offload_bytes", 64 * 1024)),
                device=self.device)
        elif backend in _NOT_PORTED_BACKENDS:
            raise NotImplementedError(
                f"comm_backend {backend!r} comes with {_NOT_PORTED_BACKENDS[backend]}; "
                "the port has LOCAL and BROKER")
        else:
            raise ValueError(f"unknown comm backend {self.backend!r}")
