"""Bonawitz SecAgg client FSM — counterpart of
``fedml_tpu/cross_silo/secagg/sa_client_manager.py``. A round on the
client:

  sync(model) → X25519 keygen, advertise the public key → on the server's
  key directory: agree the pairwise seeds, Shamir-share the self-mask seed
  (row j to client j, relayed by the server) → train, quantize, mask (self
  + pairwise), upload → on the reconstruction request: reveal the held
  self-seed shares of the SURVIVORS and the pairwise seeds shared with the
  DROPPED clients, never both for one client.

The math is ``core/mpc/secagg.py`` on the host; the model arrives in the
reference's message form and is trained on this client's device; the
finite vector is built in the reference's leaf order and layout
(``core/mpc/finite.tree_to_finite``). ``sa_simulate_dropout_rank`` makes
that rank go silent after the key and share exchange of round 0 (test
scaffolding; a production dropout is the server's timeout).
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Optional

import numpy as np
import torch

from fedml_tpu_torch.core.distributed.fedml_comm_manager import (
    COMM_BACKEND_LOCAL,
    FedMLCommManager,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.core.mpc.finite import DEFAULT_PRIME, mulmod, tree_to_finite
from fedml_tpu_torch.core.mpc.secagg import SecAggClient
from fedml_tpu_torch.cross_silo.secagg.sa_message_define import SAMessage
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.models.convert import from_wire_params

logger = logging.getLogger(__name__)


def host_int64(x: Any) -> np.ndarray:
    """A field vector as received (numpy, or a tensor the wire decoded on
    the device) → host int64 numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.int64)


class ProtocolClient(FedMLCommManager):
    """What the Bonawitz and LightSecAgg clients share: the status
    handshake and the finish."""

    def __init__(self, args: Any, trainer_dist_adapter, comm=None, rank: int = 0,
                 size: int = 0, backend: str = COMM_BACKEND_LOCAL,
                 device: DeviceLike = "cpu"):
        super().__init__(args, comm, rank, size, backend, device)
        self.adapter = trainer_dist_adapter
        self.num_rounds = int(getattr(args, "comm_round", 1))
        self.round_idx = 0
        self.n_clients = size - 1
        self.has_sent_online_msg = False

    def handle_connection_ready(self, msg: Message) -> None:
        if not self.has_sent_online_msg:
            self.has_sent_online_msg = True
            self._send_status(0)

    def handle_check_status(self, msg: Message) -> None:
        self._send_status(msg.get_sender_id())

    def _send_status(self, receiver: int) -> None:
        m = Message(SAMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.get_sender_id(), receiver)
        m.add_params(SAMessage.MSG_ARG_KEY_CLIENT_STATUS, SAMessage.MSG_CLIENT_STATUS_IDLE)
        self.send_message(m)

    def handle_finish(self, msg: Message) -> None:
        self.finish()


class SAClientManager(ProtocolClient):
    def __init__(self, args: Any, trainer_dist_adapter, comm=None, rank: int = 0,
                 size: int = 0, backend: str = COMM_BACKEND_LOCAL,
                 device: DeviceLike = "cpu"):
        super().__init__(args, trainer_dist_adapter, comm, rank, size, backend, device)
        self.threshold = int(getattr(args, "sa_threshold", max(1, self.n_clients // 2)))
        self.p = int(getattr(args, "sa_prime", DEFAULT_PRIME))
        self.q_bits = int(getattr(args, "sa_q_bits", 16))
        self.simulate_dropout = int(getattr(args, "sa_simulate_dropout_rank", -1)) == rank
        self._reset_round_state()

    def _reset_round_state(self) -> None:
        self.sa: Optional[SecAggClient] = None
        self.held_shares: Dict[int, np.ndarray] = {}  # owner rank → this client's share
        self.global_params = None
        self.silo_idx = None
        self.reconstruction_answered = False

    def register_message_receive_handlers(self) -> None:
        M = SAMessage
        for msg_type, handler in (
                (M.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready),
                (M.MSG_TYPE_S2C_CHECK_CLIENT_STATUS, self.handle_check_status),
                (M.MSG_TYPE_S2C_INIT_CONFIG, self.handle_sync_model),
                (M.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, self.handle_sync_model),
                (M.MSG_TYPE_S2C_BROADCAST_PUBLIC_KEYS, self.handle_public_keys),
                (M.MSG_TYPE_S2C_FORWARD_SEED_SHARE, self.handle_seed_share),
                (M.MSG_TYPE_S2C_REQUEST_RECONSTRUCTION, self.handle_reconstruction),
                (M.MSG_TYPE_S2C_FINISH, self.handle_finish)):
            self.register_message_receive_handler(msg_type, handler)

    # -- round body --------------------------------------------------------------
    def handle_sync_model(self, msg: Message) -> None:
        M = SAMessage
        self._reset_round_state()
        self.global_params = from_wire_params(msg.get(M.MSG_ARG_KEY_MODEL_PARAMS),
                                              self.device)
        self.silo_idx = int(msg.get(M.MSG_ARG_KEY_CLIENT_INDEX))
        self.round_idx = int(msg.get(M.MSG_ARG_KEY_ROUND, self.round_idx))
        # fresh keys each round from OS entropy; the dimension is set after
        # training, the key goes out now
        self.sa = SecAggClient(client_id=self.rank, n_clients=self.n_clients,
                               threshold=self.threshold, dim=1, p=self.p)
        m = Message(M.MSG_TYPE_C2S_SEND_PUBLIC_KEY, self.get_sender_id(), 0)
        m.add_params(M.MSG_ARG_KEY_PUBLIC_KEY, self.sa.pk)
        m.add_params(M.MSG_ARG_KEY_ROUND, self.round_idx)
        self.send_message(m)

    def handle_public_keys(self, msg: Message) -> None:
        M = SAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.round_idx)) != self.round_idx:
            return
        pks = {int(k): v for k, v in msg.get(M.MSG_ARG_KEY_PUBLIC_KEYS).items()}
        # SecAggClient ids are the (1-based) ranks throughout
        self.sa.set_peer_keys({j: pk for j, pk in pks.items() if j != self.rank})
        # Shamir row h (0-based) goes to rank h + 1; this client keeps its own
        shares = self.sa.self_seed_shares()
        for h in range(self.n_clients):
            rank_h = h + 1
            if rank_h == self.rank:
                self.held_shares[self.rank] = shares[h]
                continue
            m = Message(M.MSG_TYPE_C2S_SEND_SEED_SHARE, self.get_sender_id(), 0)
            m.add_params(M.MSG_ARG_KEY_SHARE_TARGET, rank_h)
            m.add_params(M.MSG_ARG_KEY_SEED_SHARE, shares[h])
            m.add_params(M.MSG_ARG_KEY_ROUND, self.round_idx)
            self.send_message(m)
        if self.simulate_dropout and self.round_idx == 0:
            # keys and shares are out; the "crash" comes before the upload,
            # announced explicitly because the in-process broker has no
            # liveness timeout
            m = Message(M.MSG_TYPE_C2S_DROPOUT, self.get_sender_id(), 0)
            m.add_params(M.MSG_ARG_KEY_ROUND, self.round_idx)
            self.send_message(m)
            return
        self._train_and_upload()

    def _train_and_upload(self) -> None:
        M = SAMessage
        self.adapter.update_dataset(self.silo_idx)
        weights, n_samples = self.adapter.train(self.round_idx, self.global_params)
        x_finite, _ = tree_to_finite(weights, self.q_bits, self.p)
        # count-weighted FedAvg under the masks: pre-scale by n_k in the field
        # (exact); the server divides the unmasked sum by Σ n_k
        x_finite = mulmod(x_finite, np.int64(int(n_samples)), self.p)
        self.sa.dim = int(x_finite.shape[0])
        up = Message(M.MSG_TYPE_C2S_SEND_MASKED_MODEL, self.get_sender_id(), 0)
        up.add_params(M.MSG_ARG_KEY_MASKED_MODEL, self.sa.mask(x_finite))
        up.add_params(M.MSG_ARG_KEY_NUM_SAMPLES, int(n_samples))
        up.add_params(M.MSG_ARG_KEY_ROUND, self.round_idx)
        self.send_message(up)

    def handle_seed_share(self, msg: Message) -> None:
        M = SAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.round_idx)) != self.round_idx:
            return
        self.held_shares[int(msg.get("origin_client"))] = host_int64(
            msg.get(M.MSG_ARG_KEY_SEED_SHARE))

    def handle_reconstruction(self, msg: Message) -> None:
        """Reveal the survivors' self-seed shares and the dropped clients'
        pairwise seeds — the self share or the pairwise seed of a peer,
        never both (that would unmask its model)."""
        M = SAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.round_idx)) != self.round_idx:
            return
        if self.reconstruction_answered:
            # one reveal a round: a second request could split the
            # survivor/dropped overlap across two disjoint-looking requests
            logger.error("SecAgg: refusing second reconstruction request in round %d",
                         self.round_idx)
            return
        survivors = [int(s) for s in msg.get(M.MSG_ARG_KEY_SURVIVORS)]
        dropped = [int(d) for d in msg.get(M.MSG_ARG_KEY_DROPPED)]
        overlap = set(survivors) & set(dropped)
        if overlap:
            logger.error("SecAgg: refusing reconstruction — clients %s appear in both "
                         "survivors and dropped", sorted(overlap))
            return
        self_shares = {owner: self.held_shares[owner]
                       for owner in survivors if owner in self.held_shares}
        pairwise = {d: self.sa.pairwise_seed(d) for d in dropped if d in self.sa.pairwise}
        self.reconstruction_answered = True
        m = Message(M.MSG_TYPE_C2S_SEND_RECONSTRUCTION, self.get_sender_id(), 0)
        m.add_params(M.MSG_ARG_KEY_SELF_SHARES, self_shares)
        m.add_params(M.MSG_ARG_KEY_PAIRWISE_SEEDS, pairwise)
        m.add_params(M.MSG_ARG_KEY_ROUND, self.round_idx)
        self.send_message(m)
