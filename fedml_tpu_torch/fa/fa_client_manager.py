"""FA client FSM — counterpart of ``fedml_tpu/fa/fa_client_manager.py``:
handshake → on an analyze request run the local analyzer over this client's
data (under the sketch spec the request's header negotiates) → submit →
repeat until FINISH.
"""
from __future__ import annotations

import logging
from typing import Any

from fedml_tpu_torch.core.distributed.fedml_comm_manager import (
    COMM_BACKEND_LOCAL,
    FedMLCommManager,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.fa.fa_message_define import FAMessage

logger = logging.getLogger(__name__)


class FAClientManager(FedMLCommManager):
    def __init__(self, args: Any, analyzer, local_data, comm=None,
                 rank: int = 0, size: int = 0, backend: str = COMM_BACKEND_LOCAL):
        super().__init__(args, comm, rank, size, backend, device=analyzer.device)
        self.analyzer = analyzer
        self.local_data = local_data
        self.has_sent_online_msg = False

    def register_message_receive_handlers(self) -> None:
        M = FAMessage
        self.register_message_receive_handler(
            M.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready)
        self.register_message_receive_handler(
            M.MSG_TYPE_S2C_CHECK_CLIENT_STATUS, self.handle_check_status)
        self.register_message_receive_handler(
            M.MSG_TYPE_S2C_ANALYZE_REQUEST, self.handle_analyze_request)
        self.register_message_receive_handler(
            M.MSG_TYPE_S2C_FINISH, self.handle_finish)

    def handle_connection_ready(self, msg: Message) -> None:
        if not self.has_sent_online_msg:
            self.has_sent_online_msg = True
            self._send_status(0)

    def handle_check_status(self, msg: Message) -> None:
        self._send_status(msg.get_sender_id())

    def _send_status(self, receiver: int) -> None:
        M = FAMessage
        m = Message(M.MSG_TYPE_C2S_CLIENT_STATUS, self.get_sender_id(), receiver)
        m.add_params(M.MSG_ARG_KEY_CLIENT_STATUS, M.MSG_CLIENT_STATUS_IDLE)
        self.send_message(m)

    def handle_analyze_request(self, msg: Message) -> None:
        M = FAMessage
        self.analyzer.set_id(int(msg.get(M.MSG_ARG_KEY_CLIENT_INDEX)))
        round_idx = int(msg.get(M.MSG_ARG_KEY_ROUND, 0))
        # the server's round-config header carries the sketch spec every
        # client must encode under: it wins over a locally configured default
        spec = msg.get(M.MSG_ARG_KEY_SKETCH_SPEC)
        if spec and hasattr(self.analyzer, "set_sketch_spec"):
            self.analyzer.set_sketch_spec(str(spec))
        submission = self.analyzer.local_analyze(
            self.local_data, msg.get(M.MSG_ARG_KEY_SERVER_STATE), round_idx)
        m = Message(M.MSG_TYPE_C2S_SUBMIT, self.get_sender_id(), 0)
        m.add_params(M.MSG_ARG_KEY_SUBMISSION, submission)
        m.add_params(M.MSG_ARG_KEY_ROUND, round_idx)
        self.send_message(m)

    def handle_finish(self, msg: Message) -> None:
        self.finish()
