"""torch-RPC federation transport (TRPC) — counterpart of
``fedml_tpu/core/distributed/communication/trpc_comm.py`` (the reference's
``trpc/trpc_comm_manager.py``).

The messages ride ``torch.distributed.rpc`` over TensorPipe: each rank
registers as worker ``fedml_rank_<i>`` (the server is rank 0, the world
the server and its clients), and a send is an ``rpc_sync`` of
:func:`_deliver` on the receiver, which the receiving process resolves by
qualified name, so a port process is called on the port's own module
(port to port, as the JAX transport is JAX to JAX). The payload is the
pickle-free wire (``safe_dumps``), never torch pickling, so a hostile peer
can at worst inject wrong numbers; the reference's CUDA-RPC tensor path
is not used (the JAX package has none). The rendezvous is
``tcp://master_addr:master_port``: the arguments, else ``MASTER_ADDR`` /
``MASTER_PORT``, else 127.0.0.1:29500. The bytes each way land in
``comm/wire_bytes_out`` / ``comm/wire_bytes_in`` (``backend=trpc``).
"""
from __future__ import annotations

import logging
import os
import threading
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

# the receiving process finds its manager here by worker name
_MANAGERS: Dict[str, "TRPCCommManager"] = {}
_MANAGERS_LOCK = threading.Lock()


def _worker_name(rank: int) -> str:
    return f"fedml_rank_{int(rank)}"


def _deliver(receiver_rank: int, payload: bytes) -> bool:
    """Runs on the receiver (``rpc_sync``): queue the wire bytes; False if
    this process has no live manager for the rank."""
    with _MANAGERS_LOCK:
        mgr = _MANAGERS.get(_worker_name(receiver_rank))
    if mgr is None:
        return False
    mgr._enqueue(payload)
    return True


class TRPCCommManager(InboxCommManager):
    def __init__(self, client_id: int = 0, client_num: int = 1,
                 master_addr: Optional[str] = None, master_port: Optional[int] = None,
                 rpc_timeout: float = 120.0, device: DeviceLike = "cpu"):
        import torch.distributed.rpc as rpc

        if not rpc.is_available():
            raise RuntimeError("torch.distributed.rpc is unavailable in this torch build; "
                               "use the BROKER, GRPC or LOCAL backend")
        super().__init__()
        self._rpc = rpc
        self.rank = int(client_id)
        self.world_size = int(client_num) + 1  # the server, rank 0, and its clients
        self.name = _worker_name(self.rank)
        self.device = torch.device(device)
        addr = master_addr or os.environ.get("MASTER_ADDR", "127.0.0.1")
        port = int(master_port or os.environ.get("MASTER_PORT", 29500))
        reg = get_registry()
        self._m_out = reg.counter("comm/wire_bytes_out", labels={"backend": "trpc"})
        self._m_in = reg.counter("comm/wire_bytes_in", labels={"backend": "trpc"})
        self._stopped = False
        with _MANAGERS_LOCK:
            _MANAGERS[self.name] = self
        try:
            rpc.init_rpc(self.name, rank=self.rank, world_size=self.world_size,
                         rpc_backend_options=rpc.TensorPipeRpcBackendOptions(
                             init_method=f"tcp://{addr}:{port}", rpc_timeout=rpc_timeout))
        except BaseException:
            with _MANAGERS_LOCK:
                _MANAGERS.pop(self.name, None)
            raise
        logger.info("TRPC up: %s in a world of %d (%s:%d)", self.name, self.world_size,
                    addr, port)

    def _enqueue(self, payload: bytes) -> None:
        self._m_in.inc(len(payload))
        self._deliver_local(Message.construct_from_params(safe_loads(payload, self.device)))

    def send_message(self, msg: Message) -> None:
        receiver = int(msg.get_receiver_id())
        payload = safe_dumps(msg.get_params())
        self._m_out.inc(len(payload))
        if not self._rpc.rpc_sync(_worker_name(receiver), _deliver, args=(receiver, payload)):
            # the peer is up but its manager is not (yet, or any more): the
            # comm manager's retry absorbs a ConnectionError
            raise ConnectionError(f"TRPC peer {receiver} has no live comm manager")

    def stop_receive_message(self) -> None:
        self._stop_inbox()
        with _MANAGERS_LOCK:
            if self._stopped:
                return
            self._stopped = True
            _MANAGERS.pop(self.name, None)
        try:
            # graceful: wait until every rank has stopped sending
            self._rpc.shutdown(graceful=True)
        except RuntimeError:
            logger.warning("rank %d: graceful RPC shutdown failed; forcing it", self.rank,
                           exc_info=True)
            self._rpc.shutdown(graceful=False)
