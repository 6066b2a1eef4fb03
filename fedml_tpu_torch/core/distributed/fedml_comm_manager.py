"""FedMLCommManager — counterpart of
``fedml_tpu/core/distributed/fedml_comm_manager.py``: a registry of
``msg_type → handler`` callbacks observing a pluggable transport.

It stamps every outgoing message with a unique id, drops duplicates on
receipt (so a resend is applied once), retries a send under the seeded
backoff, notes every sender's liveness, and records a raising handler in
``handler_error`` and stops its receive loop, so a federation fails loudly
instead of hanging. The transports are ``LOCAL`` (in-process), ``BROKER``
(pub/sub with the object-store offload: the in-tree broker, Python or C++,
or MQTT under ``broker_protocol: mqtt``), ``MQTT_S3`` (the reference's
default: the same manager forced to MQTT, at ``mqtt_host``/``mqtt_port``),
``GRPC`` (a server a rank at ``grpc_base_port + rank``, hosts from
``grpc_ipconfig``) and ``TRPC`` (``torch.distributed.rpc`` with the
rendezvous at ``trpc_master_addr``/``trpc_master_port``); ``XLA_ICI``'s
device collectives come with the multi-GPU layer (A11): naming it raises.
With
``args.chaos`` a seeded :class:`~fedml_tpu_torch.resilience.ChaosInjector`
sits at the reference's seam: it filters inbound delivery before the dedup,
and on the way out corrupts a model payload in its window, then decides
the copies (0 drops, 2 duplicates) and the delay. Its windows read the
message's ``round`` header, else the manager's own ``round_idx`` (a client)
or ``args.round_idx`` (the server).

Every send carries the open span's context as the reference's
``telemetry_ctx`` header, and every receive re-activates it around its
handler under a ``comm/dispatch`` span, so a rank's spans join the
sender's trace, across the two packages too. Sends and receives are
``comm/send`` / ``comm/recv`` point events and flight-recorder records,
and a raising handler dumps the flight recorder. The live plane rides the
same seam: with a ``live_streamer`` (a ``MetricStreamer``) or a
``trace_streamer`` (a ``SpanStreamer``) set, each send pops one prepared
frame of each onto the message before the chaos seam, and each receive
hands a piggybacked frame to this process's ``LivePlane``, if one is
bound. The registry counters keep the reference's names.
"""
from __future__ import annotations

import logging
import threading
import time
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
from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.live import ingest_frame, ingest_trace_frame
from fedml_tpu_torch.telemetry.registry import get_registry
from fedml_tpu_torch.telemetry.spans import (
    activate_context,
    deactivate_context,
    extract_context,
    get_tracer,
    inject_context,
)

logger = logging.getLogger(__name__)

COMM_BACKEND_LOCAL = "LOCAL"
COMM_BACKEND_BROKER = "BROKER"
COMM_BACKEND_MQTT_S3 = "MQTT_S3"
COMM_BACKEND_GRPC = "GRPC"
COMM_BACKEND_TRPC = "TRPC"
# the backends that kick their own FSM once connected
_SELF_READY_BACKENDS = (COMM_BACKEND_BROKER, COMM_BACKEND_MQTT_S3, COMM_BACKEND_GRPC,
                        COMM_BACKEND_TRPC)
# backends of the reference the port does not have yet → the ROADMAP item
_NOT_PORTED_BACKENDS = {"XLA_ICI": "the multi-GPU layer, ROADMAP A11"}


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
        self._chaos = chaos_from_args(
            args, self.rank,
            round_provider=lambda: getattr(self, "round_idx",
                                           getattr(self.args, "round_idx", None)))
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
        # the live plane's streamers (None unless a client sets them): with
        # both None a send pays two None-checks
        self.live_streamer = None
        self.trace_streamer = None
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
        CONNECTION_IS_READY, as the reference's MQTT manager does from its
        on_connect; the in-process harness posts it to every rank once all
        are up."""
        if str(self.backend).upper() in _SELF_READY_BACKENDS:
            self.receive_message(
                self.MSG_TYPE_CONNECTION_IS_READY,
                Message(self.MSG_TYPE_CONNECTION_IS_READY, self.rank, self.rank))

    def get_sender_id(self) -> int:
        return self.rank

    def receive_message(self, msg_type: str, msg_params: Message) -> None:
        # chaos: a partitioned or killed peer's in-flight messages must not
        # leak through the cut
        if self._chaos is not None and not self._chaos.on_deliver(msg_params):
            return
        msg_id = msg_params.get(Message.MSG_ARG_KEY_MSG_ID)
        if msg_id is not None and self._deduper.seen(msg_id):
            self._m_dups.inc()
            flight_recorder.record("duplicate_dropped", rank=self.rank,
                                   msg_type=str(msg_type), msg_id=msg_id)
            logger.debug("rank %d: duplicate %s dropped (%s)", self.rank, msg_type, msg_id)
            return
        self.liveness.note(msg_params.get_sender_id())
        # a piggybacked frame merges into this process's collector, if one is
        # bound, whatever the message; the collector's seq gate absorbs the
        # same frame on a resent or duplicated message
        frame = msg_params.get(Message.MSG_ARG_KEY_TELEMETRY)
        if frame is not None:
            try:
                ingest_frame(frame)
            except Exception:  # noqa: BLE001 - observability never breaks the round
                logger.exception("telemetry frame ingest failed")
        tframe = msg_params.get(Message.MSG_ARG_KEY_TRACE)
        if tframe is not None:
            try:
                ingest_trace_frame(tframe)
            except Exception:  # noqa: BLE001
                logger.exception("trace frame ingest failed")
        handler = self.message_handler_dict.get(str(msg_type))
        if handler is None:
            logger.warning("rank %d: no handler for %s", self.rank, msg_type)
            return
        rnd = msg_params.get("round")
        at_round = {"round": rnd} if rnd is not None else {}
        flight_recorder.record("comm_recv", msg_type=str(msg_type), rank=self.rank,
                               sender=msg_params.get_sender_id(), **at_round)
        tracer = get_tracer()
        if msg_id is not None:
            tracer.event("comm/recv", msg_id=msg_id, peer=msg_params.get_sender_id(),
                         msg_type=str(msg_type), **at_round)
        # the sender's context, injected by its send_message: this rank's
        # handler spans stitch into the sender's trace
        ctx = extract_context(msg_params.get_params())
        token = activate_context(ctx)
        try:
            if ctx is not None:
                with tracer.span("comm/dispatch", msg_type=str(msg_type), rank=self.rank,
                                 sender=msg_params.get_sender_id(),
                                 **({"msg_id": msg_id} if msg_id is not None else {}),
                                 **at_round):
                    handler(msg_params)
            else:
                handler(msg_params)
        except BaseException as e:
            # a raising handler must not silently kill the receive thread
            # and hang the federation: record it, land the flight recorder
            # (the exception never reaches an excepthook) and stop this
            # rank's loop
            self.handler_error = e
            logger.exception("rank %d: handler for %s raised; stopping receive loop",
                             self.rank, msg_type)
            flight_recorder.record("handler_error", msg_type=str(msg_type), rank=self.rank,
                                   error=repr(e))
            flight_recorder.get_flight_recorder().dump(reason="handler_error", exc=e)
            self.com_manager.stop_receive_message()
        finally:
            deactivate_context(token)

    def send_message(self, message: Message) -> None:
        # the open span's context rides the message as a header
        inject_context(message.get_params())
        # stamped once per logical message: a retried send keeps its id, so
        # the receiver drops the copy if the first attempt did land
        if message.get(Message.MSG_ARG_KEY_MSG_ID) is None:
            message.add_params(Message.MSG_ARG_KEY_MSG_ID,
                               self._msg_id_prefix + str(next(self._send_seq)))
        rnd = message.get("round")
        at_round = {"round": rnd} if rnd is not None else {}
        get_tracer().event("comm/send", msg_id=message.get(Message.MSG_ARG_KEY_MSG_ID),
                           peer=message.get_receiver_id(), msg_type=message.get_type(),
                           **at_round)
        flight_recorder.record("comm_send", msg_type=message.get_type(), rank=self.rank,
                               receiver=message.get_receiver_id(), **at_round)
        self._m_sent.inc()
        payload = message.get(Message.MSG_ARG_KEY_MODEL_PARAMS)
        if payload is not None:
            from fedml_tpu_torch.compression import CompressedTree
            from fedml_tpu_torch.utils.serialization import tree_nbytes

            self._m_raw.inc(payload.raw_nbytes if isinstance(payload, CompressedTree)
                            else tree_nbytes(payload))
        # one prepared frame of each stream (rate-limited in the streamer),
        # before the chaos seam: an injected drop or duplicate exercises the
        # collectors' recovery
        if (self.live_streamer is not None
                and message.get(Message.MSG_ARG_KEY_TELEMETRY) is None):
            try:
                frame = self.live_streamer.pop_frame()
                if frame is not None:
                    message.add_params(Message.MSG_ARG_KEY_TELEMETRY, frame)
                    get_registry().counter("live/frames_piggybacked").inc()
            except Exception:  # noqa: BLE001 - observability never breaks the send
                logger.exception("telemetry frame piggyback failed")
        if (self.trace_streamer is not None
                and message.get(Message.MSG_ARG_KEY_TRACE) is None):
            try:
                tframe = self.trace_streamer.pop_frame()
                if tframe is not None:
                    message.add_params(Message.MSG_ARG_KEY_TRACE, tframe)
            except Exception:  # noqa: BLE001
                logger.exception("trace frame piggyback failed")

        copies, delay_s = 1, 0.0
        if self._chaos is not None:
            # after the encode, before the wire
            self._chaos.corrupt_payload(message)
            copies, delay_s = self._chaos.on_send(message)
        if delay_s > 0:
            time.sleep(delay_s)
        for _ in range(copies):
            self._send_with_retry(message)

    def _send_with_retry(self, message: Message) -> None:
        """One transport send under the seeded backoff."""

        def on_retry(attempt: int, exc: BaseException) -> None:
            self._m_retries.inc()
            flight_recorder.record("send_retry", rank=self.rank, attempt=attempt,
                                   msg_type=message.get_type(), error=repr(exc))

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
        elif backend in (COMM_BACKEND_BROKER, COMM_BACKEND_MQTT_S3):
            from fedml_tpu_torch.core.distributed.communication.broker_comm import (
                BrokerCommManager,
            )
            from fedml_tpu_torch.core.distributed.communication.object_store import (
                create_object_store,
            )

            a = self.args
            if backend == COMM_BACKEND_MQTT_S3:
                protocol = "mqtt"
                host = getattr(a, "mqtt_host", getattr(a, "broker_host", "127.0.0.1"))
                port = getattr(a, "mqtt_port", getattr(a, "broker_port", 1883))
            else:
                protocol = str(getattr(a, "broker_protocol", "tcp"))
                host = getattr(a, "broker_host", "127.0.0.1")
                port = getattr(a, "broker_port", 1883)
            self.com_manager = BrokerCommManager(
                run_id, self.rank, host=str(host), port=int(port),
                object_store=create_object_store(a),
                offload_bytes=int(getattr(a, "payload_offload_bytes", 64 * 1024)),
                device=self.device, protocol=protocol)
        elif backend == COMM_BACKEND_GRPC:
            from fedml_tpu_torch.core.distributed.communication.grpc_comm import (
                GRPC_BASE_PORT,
                GRPCCommManager,
            )

            self.com_manager = GRPCCommManager(
                ip_config=getattr(self.args, "grpc_ipconfig", None), client_id=self.rank,
                client_num=self.size - 1,
                base_port=int(getattr(self.args, "grpc_base_port", GRPC_BASE_PORT)),
                device=self.device)
        elif backend == COMM_BACKEND_TRPC:
            from fedml_tpu_torch.core.distributed.communication.trpc_comm import (
                TRPCCommManager,
            )

            # the world is this manager's size: the server and its clients
            self.com_manager = TRPCCommManager(
                client_id=self.rank, client_num=self.size - 1,
                master_addr=getattr(self.args, "trpc_master_addr", None),
                master_port=getattr(self.args, "trpc_master_port", None),
                device=self.device)
        elif backend in _NOT_PORTED_BACKENDS:
            raise NotImplementedError(
                f"comm_backend {backend!r} comes with {_NOT_PORTED_BACKENDS[backend]}; "
                "the port has LOCAL, BROKER, MQTT_S3, GRPC and TRPC")
        else:
            raise ValueError(f"unknown comm backend {self.backend!r}")
