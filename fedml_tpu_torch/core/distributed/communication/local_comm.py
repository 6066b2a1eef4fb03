"""Deterministic in-process transport — counterpart of
``fedml_tpu/core/distributed/communication/local_comm.py``.

Every rank has an inbox queue in a per-run broker; a send enqueues the
message object itself (no bytes), and each manager drains its own inbox on
its own thread or cooperatively through :meth:`LocalCommManager.pump`.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

from fedml_tpu_torch.core.distributed.communication.base_com_manager import (
    BaseCommunicationManager,
    Observer,
)
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.telemetry import get_registry


class LocalBroker:
    """Per-run registry of rank inboxes, process-wide, keyed by run id."""

    _instances: Dict[str, "LocalBroker"] = {}
    _lock = threading.Lock()

    def __init__(self):
        # a plain dict under a lock: a defaultdict's first access would race
        # between sender and receiver threads and orphan a queue
        self.inboxes: Dict[int, "queue.Queue[Optional[Message]]"] = {}
        self._inbox_lock = threading.Lock()

    @classmethod
    def get(cls, run_id: str) -> "LocalBroker":
        with cls._lock:
            if run_id not in cls._instances:
                cls._instances[run_id] = cls()
            return cls._instances[run_id]

    @classmethod
    def destroy(cls, run_id: str) -> None:
        with cls._lock:
            cls._instances.pop(run_id, None)

    def inbox(self, rank: int) -> "queue.Queue[Optional[Message]]":
        with self._inbox_lock:
            q = self.inboxes.get(rank)
            if q is None:
                q = queue.Queue()
                self.inboxes[rank] = q
            return q

    def post(self, receiver_id: int, msg: Optional[Message]) -> None:
        self.inbox(receiver_id).put(msg)


class LocalCommManager(BaseCommunicationManager):
    def __init__(self, run_id: str, rank: int):
        self.run_id = str(run_id)
        self.rank = int(rank)
        self.broker = LocalBroker.get(self.run_id)
        self._observers: List[Observer] = []
        self._running = False
        self._m_delivered = get_registry().counter(
            "comm/messages_delivered", labels={"backend": "local"})

    def send_message(self, msg: Message) -> None:
        self._m_delivered.inc()
        self.broker.post(msg.get_receiver_id(), msg)

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def _deliver(self, msg: Message) -> None:
        for obs in list(self._observers):
            obs.receive_message(msg.get_type(), msg)

    def handle_receive_message(self) -> None:
        self._running = True
        inbox = self.broker.inbox(self.rank)
        while self._running:
            try:
                msg = inbox.get(timeout=0.2)
            except queue.Empty:
                continue
            if msg is None:  # poison pill
                break
            self._deliver(msg)

    def pump(self, max_messages: int = 0) -> int:
        """Cooperative drain (no thread): deliver pending messages now."""
        inbox = self.broker.inbox(self.rank)
        n = 0
        while not inbox.empty() and (max_messages == 0 or n < max_messages):
            msg = inbox.get_nowait()
            if msg is None:
                break
            self._deliver(msg)
            n += 1
        return n

    def stop_receive_message(self) -> None:
        self._running = False
        self.broker.post(self.rank, None)
