"""gRPC federation transport — counterpart of
``fedml_tpu/core/distributed/communication/grpc_comm.py`` (the reference's
``grpc/grpc_comm_manager.py``).

One gRPC server a rank at ``base_port + rank``, the peers' addresses from
an ip table (rank → host). The service is the reference's contract, a
unary ``fedml.CommunicationService/sendMessage`` carrying opaque bytes,
registered generically (no codegen), and the bytes are the pickle-free
wire (``utils/serialization.safe_dumps``), so a JAX peer and a port peer
talk to each other. Messages are capped at 512 MiB each way; a send waits
for the peer to be ready, up to 120 s. The bytes each way land in
``comm/wire_bytes_out`` / ``comm/wire_bytes_in`` (``backend=grpc``).
"""
from __future__ import annotations

import logging
import threading
from concurrent import futures
from typing import Dict, Optional

import torch

from fedml_tpu_torch.core.distributed.communication.base_com_manager import (
    InboxCommManager,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.serialization import safe_dumps, safe_loads

logger = logging.getLogger(__name__)

GRPC_BASE_PORT = 8890  # the reference's communication/grpc/constants.py
_MAX_MSG = 512 * 1024 * 1024
_OPTIONS = [("grpc.max_send_message_length", _MAX_MSG),
            ("grpc.max_receive_message_length", _MAX_MSG)]
_SERVICE = "fedml.CommunicationService"
_METHOD = "sendMessage"
SEND_TIMEOUT_S = 120.0


def _identity(b: bytes) -> bytes:
    return b


class GRPCCommManager(InboxCommManager):
    def __init__(self, host: str = "0.0.0.0", port: Optional[int] = None,
                 ip_config: Optional[Dict] = None, client_id: int = 0, client_num: int = 1,
                 base_port: int = GRPC_BASE_PORT, device: DeviceLike = "cpu"):
        try:
            import grpc
        except ImportError as e:
            raise RuntimeError("grpcio is not installed; use the LOCAL or BROKER "
                               "backend") from e
        super().__init__()
        self._grpc = grpc
        self.rank = int(client_id)
        self.client_num = int(client_num)
        self.base_port = int(base_port)
        self.port = int(port if port is not None else self.base_port + self.rank)
        self.device = torch.device(device)
        # a config read from JSON has string ranks: key the table by int
        self.ip_config = ({int(r): str(ip) for r, ip in ip_config.items()} if ip_config
                          else {r: "127.0.0.1" for r in range(self.client_num + 1)})
        reg = get_registry()
        self._m_out = reg.counter("comm/wire_bytes_out", labels={"backend": "grpc"})
        self._m_in = reg.counter("comm/wire_bytes_in", labels={"backend": "grpc"})
        rpc = grpc.unary_unary_rpc_method_handler(
            self._on_request, request_deserializer=_identity, response_serializer=_identity)
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=4),
                                   options=_OPTIONS)
        self._server.add_generic_rpc_handlers(
            (grpc.method_handlers_generic_handler(_SERVICE, {_METHOD: rpc}),))
        if not self._server.add_insecure_port(f"{host}:{self.port}"):
            raise OSError(f"gRPC rank {self.rank} cannot bind {host}:{self.port}")
        self._server.start()
        self._channels: Dict[int, "grpc.Channel"] = {}
        self._stubs: Dict[int, "grpc.UnaryUnaryMultiCallable"] = {}
        self._lock = threading.Lock()  # the timer, heartbeat and receive threads send

    def _on_request(self, request: bytes, context) -> bytes:
        self._m_in.inc(len(request))
        self._deliver_local(Message.construct_from_params(safe_loads(request, self.device)))
        return b"ok"

    def _stub(self, receiver_id: int):
        with self._lock:
            stub = self._stubs.get(receiver_id)
            if stub is None:
                ip = self.ip_config.get(receiver_id, "127.0.0.1")
                channel = self._grpc.insecure_channel(
                    f"{ip}:{self.base_port + receiver_id}", options=_OPTIONS)
                self._channels[receiver_id] = channel
                stub = self._stubs[receiver_id] = channel.unary_unary(
                    f"/{_SERVICE}/{_METHOD}", request_serializer=_identity,
                    response_deserializer=_identity)
            return stub

    def send_message(self, msg: Message) -> None:
        payload = safe_dumps(msg.get_params())
        self._m_out.inc(len(payload))
        # a failure surfaces as grpc.RpcError (UNAVAILABLE, DEADLINE_EXCEEDED),
        # which the comm manager's retry treats as transient
        self._stub(int(msg.get_receiver_id()))(payload, wait_for_ready=True,
                                               timeout=SEND_TIMEOUT_S)

    def stop_receive_message(self) -> None:
        self._stop_inbox()
        self._server.stop(grace=0.5)
        with self._lock:
            for ch in self._channels.values():
                ch.close()
