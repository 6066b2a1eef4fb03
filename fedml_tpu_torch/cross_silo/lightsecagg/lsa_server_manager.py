"""LightSecAgg server FSM — counterpart of
``fedml_tpu/cross_silo/lightsecagg/lsa_server_manager.py``. The server:

  handshake → init → relay the encoded-mask rows between clients → collect
  every masked model → broadcast the active set, asking for the aggregate
  encoded masks → decode Σ z_i from the first U answers (LCC, the port's
  C++ library) → unmask, dequantize, average → test → next round.

It sees only x_i + z_i and the coded aggregate of the masks. The field
work is host numpy; the aggregate goes to the server's device in the
port's layout.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from fedml_tpu_torch.core.distributed.fedml_comm_manager import COMM_BACKEND_LOCAL
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.core.mpc.finite import finite_to_tree
from fedml_tpu_torch.core.mpc.lightsecagg import decode_aggregate_mask
from fedml_tpu_torch.cross_silo.lightsecagg.lsa_client_manager import lsa_geometry
from fedml_tpu_torch.cross_silo.lightsecagg.lsa_message_define import LSAMessage
from fedml_tpu_torch.cross_silo.secagg.sa_client_manager import host_int64
from fedml_tpu_torch.cross_silo.secagg.sa_server_manager import ProtocolServer
from fedml_tpu_torch.device import DeviceLike

logger = logging.getLogger(__name__)


class LSAServerManager(ProtocolServer):
    def __init__(self, args: Any, aggregator, comm=None, client_rank: int = 0,
                 client_num: int = 0, backend: str = COMM_BACKEND_LOCAL,
                 device: DeviceLike = "cpu"):
        super().__init__(args, aggregator, comm, client_rank, client_num, backend, device)
        self.targeted_active, self.privacy_t, self.p, self.q_bits = lsa_geometry(
            args, client_num)
        self._reset_round_state()

    def _reset_round_state(self) -> None:
        self.masked_models: Dict[int, np.ndarray] = {}
        self.sample_nums: Dict[int, int] = {}
        self.agg_points: Dict[int, np.ndarray] = {}
        self.active_set: Optional[List[int]] = None
        self.round_done = False

    def register_message_receive_handlers(self) -> None:
        M = LSAMessage
        for msg_type, handler in (
                (M.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready),
                (M.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_client_status),
                (M.MSG_TYPE_C2S_SEND_ENCODED_MASK, self.handle_relay_encoded_mask),
                (M.MSG_TYPE_C2S_SEND_MASKED_MODEL, self.handle_masked_model),
                (M.MSG_TYPE_C2S_SEND_AGG_MASK, self.handle_agg_mask)):
            self.register_message_receive_handler(msg_type, handler)

    # -- round body -----------------------------------------------------------------
    def handle_relay_encoded_mask(self, msg: Message) -> None:
        M = LSAMessage
        fwd = Message(M.MSG_TYPE_S2C_FORWARD_ENCODED_MASK, self.get_sender_id(),
                      int(msg.get(M.MSG_ARG_KEY_MASK_TARGET)))
        fwd.add_params("origin_client", msg.get_sender_id())
        fwd.add_params(M.MSG_ARG_KEY_ENCODED_MASK, msg.get(M.MSG_ARG_KEY_ENCODED_MASK))
        fwd.add_params(M.MSG_ARG_KEY_ROUND, msg.get(M.MSG_ARG_KEY_ROUND, self.args.round_idx))
        self.send_message(fwd)

    def handle_masked_model(self, msg: Message) -> None:
        M = LSAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.args.round_idx)) != self.args.round_idx:
            return
        sender = msg.get_sender_id()
        self.masked_models[sender] = host_int64(msg.get(M.MSG_ARG_KEY_MASKED_MODEL))
        self.sample_nums[sender] = int(msg.get(M.MSG_ARG_KEY_NUM_SAMPLES))
        if len(self.masked_models) == self.client_num:
            # every upload is in: open the one-shot unmask
            self.active_set = sorted(self.masked_models)
            for cid in self.active_set:
                m = Message(M.MSG_TYPE_S2C_REQUEST_AGG_MASK, self.get_sender_id(), cid)
                m.add_params(M.MSG_ARG_KEY_ACTIVE_CLIENTS, list(self.active_set))
                m.add_params(M.MSG_ARG_KEY_ROUND, self.args.round_idx)
                self.send_message(m)

    def unmask_sum(self) -> np.ndarray:
        """Σ x_i over the active set from the first U aggregate points."""
        dim = self.masked_models[self.active_set[0]].shape[0]
        # client ranks are 1-based, LCC's alpha indices 0-based
        agg_mask = decode_aggregate_mask(
            {cid - 1: v for cid, v in self.agg_points.items()},
            dim, self.client_num, self.targeted_active, self.privacy_t, self.p)
        agg = np.zeros(dim, np.int64)
        for cid in self.active_set:
            agg = np.mod(agg + self.masked_models[cid], self.p)
        return np.mod(agg - agg_mask, self.p)

    def handle_agg_mask(self, msg: Message) -> None:
        M = LSAMessage
        # a straggler's answer from an earlier round must not enter this decode
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.args.round_idx)) != self.args.round_idx:
            return
        if self.round_done:
            return
        self.agg_points[msg.get_sender_id()] = host_int64(
            msg.get(M.MSG_ARG_KEY_AGG_ENCODED_MASK))
        if len(self.agg_points) < self.targeted_active:
            return
        self.round_done = True
        agg_finite = self.unmask_sum()
        # dequantize the sum, then the uniform average (dequantize is linear)
        summed = finite_to_tree(agg_finite, self.aggregator.get_global_model_params(),
                                self.q_bits, self.p, n_summands=len(self.active_set))
        n_active = torch.tensor(float(len(self.active_set)), dtype=torch.float32)
        averaged = {k: (v / n_active).to(self.device) for k, v in summed.items()}
        self._close_round(averaged, "lightsecagg")
