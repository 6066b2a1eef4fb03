"""LightSecAgg client FSM — counterpart of
``fedml_tpu/cross_silo/lightsecagg/lsa_client_manager.py``. A round on the
client:

  sync(model) → train on this client's device → quantize the model on the
  host (the reference's leaf order and layout) → draw the mask z from OS
  entropy, LCC-encode it and send row j to client j (relayed) → upload
  x + z → on the server's request (with the active set) send Σ over the
  active senders of the rows it holds: one vector, the one-shot unmask.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np

from fedml_tpu_torch.core.distributed.fedml_comm_manager import COMM_BACKEND_LOCAL
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.core.mpc.finite import DEFAULT_PRIME, tree_to_finite
from fedml_tpu_torch.core.mpc.lightsecagg import (
    compute_aggregate_encoded_mask,
    mask_encoding,
    model_masking,
)
from fedml_tpu_torch.cross_silo.lightsecagg.lsa_message_define import LSAMessage
from fedml_tpu_torch.cross_silo.secagg.sa_client_manager import ProtocolClient, host_int64
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.models.convert import from_wire_params

logger = logging.getLogger(__name__)


def lsa_geometry(args: Any, n_clients: int):
    """(U survivors needed, T colluders tolerated, prime, q_bits) from the
    ``lsa_*`` arguments, with the reference's defaults."""
    u = int(getattr(args, "lsa_targeted_active", max(2, n_clients - 1)))
    t = int(getattr(args, "lsa_privacy_guarantee", max(1, u // 2 - 1)))
    return (u, t, int(getattr(args, "lsa_prime", DEFAULT_PRIME)),
            int(getattr(args, "lsa_q_bits", 16)))


class LSAClientManager(ProtocolClient):
    def __init__(self, args: Any, trainer_dist_adapter, comm=None, rank: int = 0,
                 size: int = 0, backend: str = COMM_BACKEND_LOCAL,
                 device: DeviceLike = "cpu"):
        super().__init__(args, trainer_dist_adapter, comm, rank, size, backend, device)
        self.targeted_active, self.privacy_t, self.p, self.q_bits = lsa_geometry(
            args, self.n_clients)
        self._reset_round_state()

    def _reset_round_state(self) -> None:
        self.local_mask: Optional[np.ndarray] = None
        self.received_rows: Dict[int, np.ndarray] = {}
        self._pending_upload: Optional[List[int]] = None

    def register_message_receive_handlers(self) -> None:
        M = LSAMessage
        for msg_type, handler in (
                (M.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready),
                (M.MSG_TYPE_S2C_CHECK_CLIENT_STATUS, self.handle_check_status),
                (M.MSG_TYPE_S2C_INIT_CONFIG, self.handle_sync_model),
                (M.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.handle_sync_model),
                (M.MSG_TYPE_S2C_FORWARD_ENCODED_MASK, self.handle_encoded_mask),
                (M.MSG_TYPE_S2C_REQUEST_AGG_MASK, self.handle_agg_mask_request),
                (M.MSG_TYPE_S2C_FINISH, self.handle_finish)):
            self.register_message_receive_handler(msg_type, handler)

    # -- round body -----------------------------------------------------------------
    def handle_sync_model(self, msg: Message) -> None:
        M = LSAMessage
        self._reset_round_state()
        global_params = from_wire_params(msg.get(M.MSG_ARG_KEY_MODEL_PARAMS), self.device)
        self.round_idx = int(msg.get(M.MSG_ARG_KEY_ROUND, self.round_idx))
        self.adapter.update_dataset(int(msg.get(M.MSG_ARG_KEY_CLIENT_INDEX)))
        weights, n_samples = self.adapter.train(self.round_idx, global_params)
        x_finite, _ = tree_to_finite(weights, self.q_bits, self.p)
        self.dim = x_finite.shape[0]
        # the mask and its LCC noise rows carry the T-collusion guarantee:
        # OS entropy, never anything the server could replay
        rng = np.random.default_rng()
        self.local_mask = rng.integers(0, self.p, size=self.dim).astype(np.int64)
        coded = mask_encoding(self.dim, self.n_clients, self.targeted_active,
                              self.privacy_t, self.p, self.local_mask, rng)
        for j, row in coded.items():  # receiver j is rank j + 1
            m = Message(M.MSG_TYPE_C2S_SEND_ENCODED_MASK, self.get_sender_id(), 0)
            m.add_params(M.MSG_ARG_KEY_MASK_TARGET, int(j + 1))
            m.add_params(M.MSG_ARG_KEY_ENCODED_MASK, row)
            m.add_params(M.MSG_ARG_KEY_ROUND, self.round_idx)
            self.send_message(m)
        up = Message(M.MSG_TYPE_C2S_SEND_MASKED_MODEL, self.get_sender_id(), 0)
        up.add_params(M.MSG_ARG_KEY_MASKED_MODEL,
                      model_masking(x_finite, self.local_mask, self.p))
        up.add_params(M.MSG_ARG_KEY_NUM_SAMPLES, int(n_samples))
        up.add_params(M.MSG_ARG_KEY_ROUND, self.round_idx)
        self.send_message(up)

    def handle_encoded_mask(self, msg: Message) -> None:
        M = LSAMessage
        # a row encoded for another round means nothing in this one
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.round_idx)) != self.round_idx:
            return
        origin = int(msg.get("origin_client", msg.get(M.MSG_ARG_KEY_SENDER)))
        self.received_rows[origin - 1] = host_int64(msg.get(M.MSG_ARG_KEY_ENCODED_MASK))
        self._maybe_answer_agg_mask()

    def handle_agg_mask_request(self, msg: Message) -> None:
        M = LSAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.round_idx)) != self.round_idx:
            return
        self._pending_upload = [int(a) for a in msg.get(M.MSG_ARG_KEY_ACTIVE_CLIENTS)]
        self._maybe_answer_agg_mask()

    def _maybe_answer_agg_mask(self) -> None:
        """Answer the one-shot request once every active client's row is
        held: the request can overtake the relayed rows."""
        active = self._pending_upload
        if active is None or any((a - 1) not in self.received_rows for a in active):
            return
        agg = compute_aggregate_encoded_mask(self.received_rows, self.p,
                                             [a - 1 for a in active])
        self._pending_upload = None
        m = Message(LSAMessage.MSG_TYPE_C2S_SEND_AGG_MASK, self.get_sender_id(), 0)
        m.add_params(LSAMessage.MSG_ARG_KEY_AGG_ENCODED_MASK, agg)
        m.add_params(LSAMessage.MSG_ARG_KEY_ROUND, self.round_idx)
        self.send_message(m)
