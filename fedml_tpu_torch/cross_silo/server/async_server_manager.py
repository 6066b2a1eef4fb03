"""Asynchronous FedAvg server FSM (FedAsync and FedBuff) — counterpart of
``fedml_tpu/cross_silo/server/async_server_manager.py``: a cross-silo
server with no round barrier.

Two modes:

- **Instant apply** (``async_buffer_size`` ≤ 1): each client update applies
  the moment it arrives,

      x ← (1 − α_s)·x + α_s·x_i,   α_s = α·(1 + staleness)^(−a)

  (Xie et al. 2019's polynomial discount); a delta-encoded compressed
  upload applies as ``x ← x + α_s·decode(Δ_i)``.
- **FedBuff** (``async_buffer_size`` = K > 1): contributions collect in a
  bounded buffer (:class:`~fedml_tpu_torch.hierarchy.FedBuffBuffer`) and
  apply in one step when it fills: compressed delta blocks reduce through
  the dequant-fused weighted sum with weights ``n_i/sqrt(1+τ_i)``, then
  ``x ← x + η·Σw̄ᵢΔᵢ``. A buffer of fresh contributions is a synchronous
  FedAvg round, and the flush does not depend on arrival order.

Either way the reporting client is handed the current model (and its
version) at once, so a lost client slows nothing down. The server
advertises its codec (the negotiation header) so clients upload compressed
deltas; the model itself ships in the reference's plain message form. The
one refused upload is a compressed full model from a codec that is not
broadcast-safe (a top-k-sparsified model is not a model).

The budget is ``async_total_updates`` applied contributions (default
``comm_round`` × clients), then the last partial flush, the test, and the
finish. The result reports ``updates``, ``versions``, ``flushes``,
``staleness`` and ``senders`` beside the test metrics.

Durability (``durability: true``): in FedBuff mode the journal
(``<checkpoint_dir>/async_buffer.journal``) makes every buffered
contribution durable in its wire form before it is buffered, and a flush
commits as marker → checkpoint → reset, so a restart with ``resume: true``
refills the buffer and never loses or double-applies a contribution (the
marker's version against the checkpointed one tells the three crash
windows apart). In instant mode every applied version is checkpointed.
The state lock serialises the replay against the comm thread's applies and
flushes, which launch on the server's device.
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, Optional

from fedml_tpu_torch.compression import CompressedTree, get_codec
from fedml_tpu_torch.core.checkpoint import (
    apply_round_state,
    engine_checkpointer,
    pack_round_state,
)
from fedml_tpu_torch.core.distributed.fedml_comm_manager import (
    COMM_BACKEND_LOCAL,
    FedMLCommManager,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.core.mlops import metrics as mlops
from fedml_tpu_torch.cross_silo.message_define import MyMessage
from fedml_tpu_torch.cross_silo.server.fedml_aggregator import FedMLAggregator
from fedml_tpu_torch.cross_silo.server.fedml_server_manager import (
    _NOT_PORTED,
    refuse_unported,
)
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.hierarchy.fedbuff import FedBuffBuffer
from fedml_tpu_torch.models.convert import (
    from_reference_layout,
    from_wire_params,
    to_reference_layout,
    to_wire_params,
)
from fedml_tpu_torch.resilience.durability import journal_from_args
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.tree import Tree

logger = logging.getLogger(__name__)


class AsyncFedMLServerManager(FedMLCommManager):
    def __init__(self, args: Any, aggregator: FedMLAggregator, comm=None,
                 client_rank: int = 0, client_num: int = 0,
                 backend: str = COMM_BACKEND_LOCAL, device: DeviceLike = "cpu"):
        refuse_unported(args, _NOT_PORTED)
        super().__init__(args, comm, client_rank, client_num + 1, backend, device)
        self.aggregator = aggregator
        self.client_num = client_num
        self.alpha = float(getattr(args, "async_alpha", 0.6))
        self.staleness_exp = float(getattr(args, "async_staleness_exponent", 0.5))
        self.total_updates = int(getattr(args, "async_total_updates",
                                         int(getattr(args, "comm_round", 1)) * client_num))
        self.version = 0   # the server model's version: one bump per applied step
        self.applied = 0   # contributions consumed toward the budget
        self.staleness_seen: list = []
        self.senders_seen: list = []
        self.client_online_status: Dict[int, bool] = {}
        self.is_initialized = False
        self.finishing = False
        self.result: Optional[dict] = None
        # the codec is advertised so clients upload compressed deltas
        self._codec = (None if getattr(args, "secure_aggregation", False)
                       else get_codec(getattr(args, "compression", ""), args))
        self.buffer_size = int(getattr(args, "async_buffer_size", 0) or 0)
        self.server_lr = float(getattr(args, "async_server_lr", 1.0))
        self._buffer: Optional[FedBuffBuffer] = None
        self.flushes = 0
        if self.buffer_size > 1:
            self._buffer = FedBuffBuffer(self.buffer_size,
                                         staleness_exponent=self.staleness_exp)
        reg = get_registry()
        self._m_staleness = reg.histogram("health/async_staleness")
        self._m_fill = reg.gauge("health/async_buffer_fill")

        self._state_lock = threading.Lock()
        self._ckpt = engine_checkpointer(args)
        self._journal = (journal_from_args(args, name="async_buffer")
                         if self._buffer is not None else None)
        self._instant_durable = (self._buffer is None
                                 and bool(getattr(args, "durability", False)))
        if self._instant_durable and self._ckpt is None:
            raise ValueError("durability: true on the instant-apply async server needs "
                             "checkpoint_dir — every applied version is made durable as "
                             "a round checkpoint")
        if self._ckpt is not None and bool(getattr(args, "resume", False)):
            restored = self._ckpt.restore_latest(
                pack_round_state(self.aggregator.get_global_model_params(),
                                 self.aggregator.server_opt, 0),
                device=self.aggregator.device)
            if restored is not None:
                _, state = restored
                self.aggregator.set_global_model_params(state["global_params"])
                self.version = apply_round_state(state, self.aggregator.server_opt)
        if self._journal is not None and bool(getattr(args, "resume", False)):
            self._replay_buffer_journal()

    # -- durability ---------------------------------------------------------------
    def _buffer_entry(self, payload: Any) -> Any:
        """An upload as the buffer holds it, in the reference's layout: a
        compressed delta as is, a compressed full model decoded (refused
        from a codec that is not broadcast-safe), a plain model from its
        wire form onto the server's device."""
        if isinstance(payload, CompressedTree):
            if payload.is_delta:
                return payload
            return self._decode_full(payload)
        return to_reference_layout(from_wire_params(payload, self.device))

    def _decode_full(self, ct: CompressedTree) -> Tree:
        codec = get_codec(ct.codec)
        if not codec.broadcast_safe:
            # a sparsified full model is a different model, not a compressed one
            raise ValueError(
                f"async server cannot apply a {codec.spec!r} compressed FULL model: "
                "upload-only codecs must ride as deltas (the negotiation header "
                "enables that); use compression=identity/bf16/int8 or delta uploads")
        return codec.decode(ct)

    def _replay_buffer_journal(self) -> None:
        """Refill the buffer from the journal after a restart. The durable
        ``buffer_flush`` marker against the checkpointed version tells the
        three crash windows apart: no marker → buffered, never flushed
        (refill and wait); a marker ahead of the checkpoint → flushed but
        not checkpointed (refill and flush again now: the flush is
        deterministic); a marker at or behind it → committed (drop the
        stale records)."""
        records = self._journal.records(device=self.aggregator.device)
        if not records:
            return
        uploads = [r for r in records if r.get("kind") == "upload_received"]
        marker = next((r for r in reversed(records) if r.get("kind") == "buffer_flush"),
                      None)
        reg = get_registry()
        reg.counter("resilience/restarts").inc()
        reg.counter("resilience/journal_replays").inc()
        if marker is not None and int(marker.get("version", 0)) <= self.version:
            logger.info("async journal: flush v%s already checkpointed; dropping %d stale "
                        "record(s)", marker.get("version"), len(records))
            with self._state_lock:
                self.applied = max(self.applied, int(marker.get("applied", 0)))
            self._journal.reset()
            return
        for u in uploads:
            self._buffer.add(int(u["sender"]), int(u["base_version"]),
                             float(u.get("n_samples") or 1.0),
                             self._buffer_entry(u.get("payload")))
            with self._state_lock:
                self.applied = max(self.applied, int(u.get("applied", 0)))
        reg.counter("resilience/journal_salvaged").inc(len(uploads))
        logger.warning("restart: async journal refilled the FedBuff buffer with %d salvaged "
                       "contribution(s) at version %d", len(uploads), self.version)
        if marker is not None and len(self._buffer):
            # flushed before the crash, never checkpointed: redo it
            self._flush_buffer()

    def register_message_receive_handlers(self) -> None:
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_CONNECTION_IS_READY, self.handle_connection_ready)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_CLIENT_STATUS, self.handle_client_status)
        self.register_message_receive_handler(
            MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, self.handle_client_update)

    # -- handshake ----------------------------------------------------------------
    def handle_connection_ready(self, msg: Message) -> None:
        if self.is_initialized:
            return
        for cid in range(1, self.client_num + 1):
            self.send_message(Message(MyMessage.MSG_TYPE_S2C_CHECK_CLIENT_STATUS,
                                      self.get_sender_id(), cid))

    def handle_client_status(self, msg: Message) -> None:
        if msg.get(MyMessage.MSG_ARG_KEY_CLIENT_STATUS) == MyMessage.MSG_CLIENT_STATUS_IDLE:
            self.client_online_status[msg.get_sender_id()] = True
        if not self.is_initialized and all(self.client_online_status.get(c, False)
                                           for c in range(1, self.client_num + 1)):
            self.is_initialized = True
            for cid in range(1, self.client_num + 1):
                self._send_model(MyMessage.MSG_TYPE_S2C_INIT_CONFIG, cid)

    def _send_model(self, msg_type: str, cid: int) -> None:
        m = Message(msg_type, self.get_sender_id(), cid)
        m.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                     to_wire_params(self.aggregator.get_global_model_params()))
        m.add_params(MyMessage.MSG_ARG_KEY_CLIENT_INDEX, cid - 1)
        m.add_params(MyMessage.MSG_ARG_KEY_ROUND, int(self.version))
        if self._codec is not None:
            m.add_params(Message.MSG_ARG_KEY_COMPRESSION, self._codec.spec)
        self.send_message(m)

    # -- the async hot path ---------------------------------------------------------
    def _apply_instant(self, w_client: Tree, is_delta: bool, staleness: int) -> None:
        """The FedAsync step: a staleness-discounted mix (full model) or
        delta add (compressed delta); both trees in the port's layout."""
        a = self.alpha * (1.0 + staleness) ** (-self.staleness_exp)
        with self._state_lock:
            x = self.aggregator.get_global_model_params()
            if is_delta:
                mixed = {k: g + a * w_client[k].to(g.dtype) if g.is_floating_point()
                         else w_client[k] for k, g in x.items()}
            else:
                mixed = {k: (1.0 - a) * g + a * w_client[k] for k, g in x.items()}
            self.aggregator.set_global_model_params(mixed)
            self.version += 1
            if self._instant_durable:
                # instant-apply durability: the applied version is the state
                self._ckpt.save(self.version, pack_round_state(
                    mixed, self.aggregator.server_opt, self.version))

    def _flush_buffer(self) -> None:
        """Apply the buffer as one staleness-weighted step; under durability
        commit it as marker → checkpoint → journal reset (a crash between
        any two replays without losing or double-applying a contribution)."""
        with self._state_lock:
            x = self.aggregator.get_global_model_params()
            new_ref, stats = self._buffer.flush(self.version, to_reference_layout(x))
            new_global = from_reference_layout(new_ref)
            if self.server_lr != 1.0:
                new_global = {k: g + self.server_lr * (new_global[k] - g)
                              if g.is_floating_point() else new_global[k]
                              for k, g in x.items()}
            self.aggregator.set_global_model_params(new_global)
            self.version += 1
            self.flushes += 1
            logger.debug("fedbuff flush v%d: %d contribution(s), mean staleness %.2f",
                         self.version, stats["flushed"], stats["mean_staleness"])
            if self._journal is not None:
                self._journal.append("buffer_flush", version=int(self.version),
                                     applied=int(self.applied),
                                     flushed=int(stats["flushed"]))
                if self._ckpt is not None:
                    self._ckpt.save(self.version, pack_round_state(
                        new_global, self.aggregator.server_opt, self.version))
                self._journal.reset()

    def handle_client_update(self, msg: Message) -> None:
        if self.finishing:
            return
        sender = msg.get_sender_id()
        wire = msg.get(MyMessage.MSG_ARG_KEY_MODEL_PARAMS)
        n_samples = float(msg.get(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, 1) or 1)
        is_delta = isinstance(wire, CompressedTree) and wire.is_delta
        if self._buffer is not None:
            entry = self._buffer_entry(wire)   # refuses before anything is counted
        elif isinstance(wire, CompressedTree):
            w_client = from_reference_layout(
                get_codec(wire.codec).decode(wire) if is_delta else self._decode_full(wire))
        else:
            w_client = from_wire_params(wire, self.device)
        base_version = int(msg.get(MyMessage.MSG_ARG_KEY_ROUND, 0))
        staleness = max(0, self.version - base_version)
        # the async world's straggler signal: ever-staler updates
        self._m_staleness.observe(float(staleness))
        with self._state_lock:
            self.applied += 1
        self.staleness_seen.append(staleness)
        self.senders_seen.append(sender)

        if self._buffer is not None:
            if self._journal is not None:
                # durable before buffered, in its wire form
                self._journal.append("upload_received", sender=int(sender),
                                     base_version=int(base_version),
                                     n_samples=float(n_samples),
                                     applied=int(self.applied), payload=wire)
            self._buffer.add(sender, base_version, n_samples, entry)
            self._m_fill.set(len(self._buffer))
            if self._buffer.full or self.applied >= self.total_updates:
                self._flush_buffer()
        else:
            self._apply_instant(w_client, is_delta, staleness)

        if self.applied >= self.total_updates:
            self.finishing = True
            metrics = self.aggregator.test_on_server_for_all_clients(self.version)
            mlops.log({"async_updates": self.applied,
                       # a replayed run may reach its budget without a fresh upload
                       "mean_staleness": float(sum(self.staleness_seen)
                                               / max(len(self.staleness_seen), 1)),
                       **metrics})
            self.result = {"updates": self.applied, "versions": self.version,
                           "flushes": self.flushes, "staleness": list(self.staleness_seen),
                           "senders": list(self.senders_seen), **metrics}
            for cid in range(1, self.client_num + 1):
                self.send_message(Message(MyMessage.MSG_TYPE_S2C_FINISH,
                                          self.get_sender_id(), cid))
            self.finish()
            return
        # the refreshed model straight back to the reporting client: no
        # barrier, the others keep training on their (stale) versions
        self._send_model(MyMessage.MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT, sender)

    def finish(self) -> None:
        if self._journal is not None:
            self._journal.close()
        super().finish()
