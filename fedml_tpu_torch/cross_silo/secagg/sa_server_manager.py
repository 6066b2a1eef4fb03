"""Bonawitz SecAgg server FSM — counterpart of
``fedml_tpu/cross_silo/secagg/sa_server_manager.py``. The server:

  handshake → init → collect the public keys, broadcast the directory →
  relay the Shamir seed-share rows between clients → collect the masked
  models (a dropout notice — in production the liveness timeout — removes
  a client from the expected set) → ask the survivors to reveal → strip
  the self masks (Shamir-reconstructed seeds) and the dropped clients'
  half-cancelled pairwise masks → dequantize the sum, divide by Σ n_k,
  test → next round.

It never sees one client's model: uploads arrive masked, and the reveals
cover only the survivors' self seeds and the dropped clients' pairwise
seeds. The finite-field work is host numpy (``core/mpc``); the aggregate
goes to the server's device in the port's layout. ``sa_threshold`` is the
Shamir degree (default ``max(1, n // 2)``), ``sa_q_bits`` the fixed-point
bits and ``sa_prime`` the field, as in the reference.
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
from fedml_tpu_torch.core.mlops import metrics as mlops
from fedml_tpu_torch.core.mpc.finite import DEFAULT_PRIME, finite_to_tree
from fedml_tpu_torch.core.mpc.secagg import SecAggServer
from fedml_tpu_torch.cross_silo.secagg.sa_client_manager import host_int64
from fedml_tpu_torch.cross_silo.secagg.sa_message_define import SAMessage
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.models.convert import to_wire_params

logger = logging.getLogger(__name__)


class ProtocolServer(FedMLCommManager):
    """What the Bonawitz and LightSecAgg servers share: the status
    handshake, the model broadcast (each silo trains part ``rank - 1``) and
    the round's close."""

    def __init__(self, args: Any, aggregator, comm=None, client_rank: int = 0,
                 client_num: int = 0, backend: str = COMM_BACKEND_LOCAL,
                 device: DeviceLike = "cpu"):
        super().__init__(args, comm, client_rank, client_num + 1, backend, device)
        self.aggregator = aggregator
        self.round_num = int(getattr(args, "comm_round", 1))
        self.args.round_idx = 0
        self.client_num = client_num
        self.client_online_status: Dict[int, bool] = {}
        self.is_initialized = False
        self.result: Optional[dict] = None

    def _reset_round_state(self) -> None:
        """Subclasses clear their per-round protocol state here."""

    def handle_connection_ready(self, msg: Message) -> None:
        if self.is_initialized:
            return
        for cid in range(1, self.client_num + 1):
            self.send_message(Message(SAMessage.MSG_TYPE_S2C_CHECK_CLIENT_STATUS,
                                      self.get_sender_id(), cid))

    def handle_client_status(self, msg: Message) -> None:
        M = SAMessage
        if msg.get(M.MSG_ARG_KEY_CLIENT_STATUS) == M.MSG_CLIENT_STATUS_IDLE:
            self.client_online_status[msg.get_sender_id()] = True
        if not self.is_initialized and all(self.client_online_status.get(c, False)
                                           for c in range(1, self.client_num + 1)):
            self.is_initialized = True
            self._sync_model(M.MSG_TYPE_S2C_INIT_CONFIG)

    def _sync_model(self, msg_type: str) -> None:
        M = SAMessage
        payload = to_wire_params(self.aggregator.get_global_model_params())
        for cid in range(1, self.client_num + 1):
            m = Message(msg_type, self.get_sender_id(), cid)
            m.add_params(M.MSG_ARG_KEY_MODEL_PARAMS, payload)
            m.add_params(M.MSG_ARG_KEY_CLIENT_INDEX, cid - 1)
            m.add_params(M.MSG_ARG_KEY_ROUND, self.args.round_idx)
            self.send_message(m)

    def _close_round(self, averaged, what: str, record: dict, **result) -> None:
        """Publish the unmasked average, test it, record the round's
        ``mlops`` line (``record`` and the metrics), and finish or open the
        next round."""
        self.aggregator.set_global_model_params(averaged)
        metrics = self.aggregator.test_on_server_for_all_clients(self.args.round_idx)
        logger.info("round %d (%s): %s", self.args.round_idx, what, metrics)
        mlops.log({"round": self.args.round_idx, **record, **metrics})
        self.args.round_idx += 1
        self._reset_round_state()
        if self.args.round_idx >= self.round_num:
            self.result = {"rounds": self.round_num, **result, **metrics}
            for cid in range(1, self.client_num + 1):
                self.send_message(Message(SAMessage.MSG_TYPE_S2C_FINISH,
                                          self.get_sender_id(), cid))
            self.finish()
            return
        self._sync_model(SAMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT)


class SAServerManager(ProtocolServer):
    def __init__(self, args: Any, aggregator, comm=None, client_rank: int = 0,
                 client_num: int = 0, backend: str = COMM_BACKEND_LOCAL,
                 device: DeviceLike = "cpu"):
        super().__init__(args, aggregator, comm, client_rank, client_num, backend, device)
        self.threshold = int(getattr(args, "sa_threshold", max(1, client_num // 2)))
        self.p = int(getattr(args, "sa_prime", DEFAULT_PRIME))
        self.q_bits = int(getattr(args, "sa_q_bits", 16))
        self._reset_round_state()

    def _reset_round_state(self) -> None:
        self.public_keys: Dict[int, bytes] = {}
        self.masked_models: Dict[int, np.ndarray] = {}
        self.sample_nums: Dict[int, int] = {}
        self.dropped: set = set()
        self.reveals: Dict[int, Dict] = {}
        self.reconstruction_requested = False
        self.round_done = False

    def register_message_receive_handlers(self) -> None:
        M = SAMessage
        for msg_type, handler in (
                (M.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready),
                (M.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_client_status),
                (M.MSG_TYPE_C2S_SEND_PUBLIC_KEY, self.handle_public_key),
                (M.MSG_TYPE_C2S_SEND_SEED_SHARE, self.handle_relay_seed_share),
                (M.MSG_TYPE_C2S_SEND_MASKED_MODEL, self.handle_masked_model),
                (M.MSG_TYPE_C2S_DROPOUT, self.handle_dropout),
                (M.MSG_TYPE_C2S_SEND_RECONSTRUCTION, self.handle_reconstruction)):
            self.register_message_receive_handler(msg_type, handler)

    # -- round body ------------------------------------------------------------------
    def handle_public_key(self, msg: Message) -> None:
        M = SAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.args.round_idx)) != self.args.round_idx:
            return
        self.public_keys[msg.get_sender_id()] = msg.get(M.MSG_ARG_KEY_PUBLIC_KEY)
        if len(self.public_keys) == self.client_num:
            for cid in range(1, self.client_num + 1):
                m = Message(M.MSG_TYPE_S2C_BROADCAST_PUBLIC_KEYS, self.get_sender_id(), cid)
                m.add_params(M.MSG_ARG_KEY_PUBLIC_KEYS, dict(self.public_keys))
                m.add_params(M.MSG_ARG_KEY_ROUND, self.args.round_idx)
                self.send_message(m)

    def handle_relay_seed_share(self, msg: Message) -> None:
        M = SAMessage
        fwd = Message(M.MSG_TYPE_S2C_FORWARD_SEED_SHARE, self.get_sender_id(),
                      int(msg.get(M.MSG_ARG_KEY_SHARE_TARGET)))
        fwd.add_params("origin_client", msg.get_sender_id())
        fwd.add_params(M.MSG_ARG_KEY_SEED_SHARE, msg.get(M.MSG_ARG_KEY_SEED_SHARE))
        fwd.add_params(M.MSG_ARG_KEY_ROUND, msg.get(M.MSG_ARG_KEY_ROUND, self.args.round_idx))
        self.send_message(fwd)

    def handle_dropout(self, msg: Message) -> None:
        """A dropout notice (the liveness timeout's stand-in)."""
        M = SAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.args.round_idx)) != self.args.round_idx:
            return
        if self.reconstruction_requested:
            # too late: the reveal requests went out against the current sets,
            # and the client uploaded, so it stays a survivor
            logger.warning("SecAgg: dropout notice from %d after reconstruction started "
                           "— ignored", msg.get_sender_id())
            return
        sender = msg.get_sender_id()
        self.dropped.add(sender)
        # a late dropout voids its upload too: keeping it while revealing its
        # pairwise seeds would unmask that model
        self.masked_models.pop(sender, None)
        self.sample_nums.pop(sender, None)
        self._maybe_request_reconstruction()

    def handle_masked_model(self, msg: Message) -> None:
        M = SAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.args.round_idx)) != self.args.round_idx:
            return
        sender = msg.get_sender_id()
        if sender in self.dropped:
            return
        self.masked_models[sender] = host_int64(msg.get(M.MSG_ARG_KEY_MASKED_MODEL))
        self.sample_nums[sender] = int(msg.get(M.MSG_ARG_KEY_NUM_SAMPLES))
        self._maybe_request_reconstruction()

    def _maybe_request_reconstruction(self) -> None:
        M = SAMessage
        if self.reconstruction_requested:
            return
        if len(self.masked_models) + len(self.dropped) < self.client_num:
            return
        survivors = sorted(self.masked_models)
        if len(survivors) <= self.threshold:
            raise RuntimeError(f"SecAgg: only {len(survivors)} survivors ≤ threshold "
                               f"{self.threshold}; aggregate unrecoverable")
        self.reconstruction_requested = True
        for cid in survivors:
            m = Message(M.MSG_TYPE_S2C_REQUEST_RECONSTRUCTION, self.get_sender_id(), cid)
            m.add_params(M.MSG_ARG_KEY_SURVIVORS, survivors)
            m.add_params(M.MSG_ARG_KEY_DROPPED, sorted(self.dropped))
            m.add_params(M.MSG_ARG_KEY_ROUND, self.args.round_idx)
            self.send_message(m)

    def handle_reconstruction(self, msg: Message) -> None:
        M = SAMessage
        if int(msg.get(M.MSG_ARG_KEY_ROUND, self.args.round_idx)) != self.args.round_idx:
            return
        if self.round_done:
            return
        self.reveals[msg.get_sender_id()] = {
            "self_shares": {int(k): host_int64(v)
                            for k, v in msg.get(M.MSG_ARG_KEY_SELF_SHARES).items()},
            "pairwise": {int(k): int(v)
                         for k, v in msg.get(M.MSG_ARG_KEY_PAIRWISE_SEEDS).items()},
        }
        survivors = sorted(self.masked_models)
        if any(s not in self.reveals for s in survivors):
            return
        self.round_done = True
        self._unmask_and_advance(survivors)

    def unmask_sum(self, survivors) -> np.ndarray:
        """The survivors' unmasked field sum Σ n_k·x_k from the reveals."""
        dim = self.masked_models[survivors[0]].shape[0]
        server = SecAggServer(self.client_num, self.threshold, dim, self.p)
        # SecAggServer takes 0-based holders (share row h is rank h + 1)
        self_seed_shares = {
            owner: {holder - 1: self.reveals[holder]["self_shares"][owner]
                    for holder in survivors
                    if owner in self.reveals[holder]["self_shares"]}
            for owner in survivors}
        dropped_pairwise = {d: {s: self.reveals[s]["pairwise"][d] for s in survivors}
                            for d in sorted(self.dropped)}
        return server.aggregate(masked=dict(self.masked_models),
                                self_seed_shares=self_seed_shares,
                                dropped_pairwise=dropped_pairwise)

    def _unmask_and_advance(self, survivors) -> None:
        agg_finite = self.unmask_sum(survivors)
        template = self.aggregator.get_global_model_params()
        summed = finite_to_tree(agg_finite, template, self.q_bits, self.p,
                                n_summands=len(survivors))
        # the clients pre-scaled by n_k: Σ n_k·x_k / Σ n_k is the count-weighted
        # FedAvg of the plain cross-silo path
        total_samples = float(sum(self.sample_nums[s] for s in survivors))
        if total_samples <= 0:
            raise RuntimeError("SecAgg: all survivors reported 0 samples; aggregate "
                               "undefined")
        # decoding needs |Σ n_k·x| · 2^q_bits < p/2, and a wrap is invisible
        # afterwards: refuse where even unit weights could wrap, warn within 8×
        headroom = (self.p / 2.0) / (total_samples * float(1 << self.q_bits))
        if headroom < 1.0:
            raise RuntimeError(
                f"SecAgg: Σ n_k = {int(total_samples)} leaves |x| < {headroom:.3f} "
                f"before field wrap at q_bits={self.q_bits}; lower sa_q_bits or raise "
                "sa_prime")
        if headroom < 8.0:
            logger.warning("SecAgg: weighted sum headroom only |x| < %.1f before field "
                           "wrap (Σ n_k = %d, q_bits=%d)", headroom, int(total_samples),
                           self.q_bits)
        total = torch.tensor(total_samples, dtype=torch.float32)
        averaged = {k: (v / total).to(self.device) for k, v in summed.items()}
        self._close_round(averaged, f"secagg, dropped {sorted(self.dropped)}",
                          {"secure": "secagg", "dropped": sorted(self.dropped)},
                          global_model=averaged)
