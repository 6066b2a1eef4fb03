"""Broker and object-store transport — counterpart of
``fedml_tpu/core/distributed/communication/broker_comm.py`` (the
reference's MQTT+S3 shape):

  control plane:  topic ``fedml/<run_id>/<receiver_rank>`` on the broker
  payload plane:  a model tree of at least ``payload_offload_bytes`` is
                  written to the object store; the message carries its key
                  (``MSG_ARG_KEY_MODEL_PARAMS_KEY``) and the receiver
                  fetches and restores it.

Messages are :func:`~fedml_tpu_torch.utils.serialization.safe_dumps` bytes,
the reference's wire, and arrays arrive as tensors on the manager's
device. Besides the reference's byte counters, ``comm/serialize_ms`` and
``comm/deserialize_ms`` (labels ``part``: ``frame`` or ``offload``) time
the (de)serialization. The broker client is any
:class:`~fedml_tpu_torch.core.distributed.communication.mqtt_compat.PubSubClient`:
``protocol`` names one (``tcp``: the in-tree broker, Python or C++;
``mqtt``: paho against an MQTT broker), or the caller passes ``client``.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Tuple

import torch

from fedml_tpu_torch.core.distributed.communication.base_com_manager import (
    InboxCommManager,
)
from fedml_tpu_torch.core.distributed.communication.mqtt_compat import (
    PubSubClient,
    create_pubsub_client,
)
from fedml_tpu_torch.core.distributed.communication.object_store import (
    ObjectStore,
    create_object_store,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.serialization import safe_dumps, safe_loads, tree_nbytes

logger = logging.getLogger(__name__)

# the model-params field is the one the reference offloads
_OFFLOADABLE_KEYS = (Message.MSG_ARG_KEY_MODEL_PARAMS,)


class BrokerCommManager(InboxCommManager):
    def __init__(self, run_id: str, rank: int, host: str = "127.0.0.1",
                 port: int = 1883, object_store: Optional[ObjectStore] = None,
                 offload_bytes: int = 64 * 1024, device: DeviceLike = "cpu",
                 protocol: str = "tcp", client: Optional[PubSubClient] = None):
        super().__init__()
        self.run_id = str(run_id)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.store = object_store or create_object_store()
        self.offload_bytes = int(offload_bytes)
        # content-addressed reclamation: a receiver cannot delete (sibling
        # receivers may still fetch the same CID), so the sender unpins its
        # own stale blobs once they leave every receiver's window and age
        self._cas_keep_last = 4
        self._cas_min_age_s = 300.0
        self._cas_sent: Dict[int, List[Tuple[str, float]]] = {}
        reg = get_registry()
        self._m_offload = reg.counter("comm/offload_bytes")
        self._m_offload_wire = reg.counter("comm/offload_wire_bytes")
        self._m_wire_out = reg.counter("comm/wire_bytes_out")
        self._m_wire_in = reg.counter("comm/wire_bytes_in")
        self._m_ser = {p: reg.histogram("comm/serialize_ms", labels={"part": p})
                       for p in ("frame", "offload")}
        self._m_deser = {p: reg.histogram("comm/deserialize_ms", labels={"part": p})
                         for p in ("frame", "offload")}
        self.client = client if client is not None else create_pubsub_client(
            protocol, host, port)
        self.client.subscribe(self._topic(self.rank), self._on_frame)

    def _topic(self, rank: int) -> str:
        return f"fedml/{self.run_id}/{rank}"

    def _reclaim_cas(self, cid: str, receiver: int) -> None:
        """Unpin the CIDs that aged out of every receiver's keep window."""
        now = time.time()
        window = [(c, t) for (c, t) in self._cas_sent.get(receiver, []) if c != cid]
        window.append((cid, now))
        self._cas_sent[receiver] = window
        while len(window) > self._cas_keep_last:
            stale, sent_at = window[0]
            if now - sent_at < self._cas_min_age_s:
                break  # possibly still in flight
            window.pop(0)
            # a broadcast dedups to one CID: keep it while another
            # receiver's window still holds it
            if any(stale == c for w in self._cas_sent.values() for (c, _) in w):
                continue
            try:
                self.store.delete_object(stale)
            except OSError:
                logger.debug("cas unpin failed for %s", stale, exc_info=True)

    # -- outbound -------------------------------------------------------------
    def send_message(self, msg: Message) -> None:
        params = dict(msg.get_params())
        for key in _OFFLOADABLE_KEYS:
            payload = params.get(key)
            if payload is None or tree_nbytes(payload) < self.offload_bytes:
                continue
            t0 = time.perf_counter()
            blob = safe_dumps(payload)
            self._m_ser["offload"].observe((time.perf_counter() - t0) * 1e3)
            # the returned key is authoritative (a CAS store returns the CID)
            store_key = self.store.put_object(
                self.store.new_key(f"{self.run_id}/r{msg.get_sender_id()}"), blob)
            self._m_offload.inc(tree_nbytes(payload))
            self._m_offload_wire.inc(len(blob))
            if self.store.content_addressed:
                self._reclaim_cas(store_key, msg.get_receiver_id())
            del params[key]
            params[Message.MSG_ARG_KEY_MODEL_PARAMS_KEY] = store_key
            params[Message.MSG_ARG_KEY_MODEL_PARAMS_URL] = f"store://{store_key}"
        t0 = time.perf_counter()
        wire = safe_dumps(params)
        self._m_ser["frame"].observe((time.perf_counter() - t0) * 1e3)
        self._m_wire_out.inc(len(wire))
        self.client.publish(self._topic(msg.get_receiver_id()), wire)

    # -- inbound --------------------------------------------------------------
    def _on_frame(self, body: bytes) -> None:
        self._m_wire_in.inc(len(body))
        try:
            t0 = time.perf_counter()
            params = safe_loads(body, self.device)
            self._m_deser["frame"].observe((time.perf_counter() - t0) * 1e3)
            store_key = params.pop(Message.MSG_ARG_KEY_MODEL_PARAMS_KEY, None)
            if store_key is not None:
                params.pop(Message.MSG_ARG_KEY_MODEL_PARAMS_URL, None)
                blob = self.store.get_object(store_key)
                t0 = time.perf_counter()
                params[Message.MSG_ARG_KEY_MODEL_PARAMS] = safe_loads(blob, self.device)
                self._m_deser["offload"].observe((time.perf_counter() - t0) * 1e3)
                # a CAS blob may still be awaited by sibling receivers
                if not self.store.content_addressed:
                    self.store.delete_object(store_key)
            self._deliver_local(Message.construct_from_params(params))
        except (ValueError, KeyError, OSError, TypeError):
            logger.exception("rank %d: bad broker frame dropped", self.rank)

    def stop_receive_message(self) -> None:
        self._stop_inbox()
        self.client.close()
