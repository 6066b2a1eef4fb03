"""BaseCommunicationManager and Observer — counterpart of
``fedml_tpu/core/distributed/communication/base_com_manager.py``: the seam
every transport implements; the FSMs never see transport details.
:class:`InboxCommManager` is the receive side the byte transports share
(broker, gRPC, tRPC): frames decoded on a transport thread land in an
inbox that :meth:`~InboxCommManager.handle_receive_message` drains."""
from __future__ import annotations

import abc
import queue
from typing import List, Optional

from fedml_tpu_torch.core.distributed.message import Message


class Observer(abc.ABC):
    @abc.abstractmethod
    def receive_message(self, msg_type: str, msg_params: Message) -> None:
        ...


class BaseCommunicationManager(abc.ABC):
    @abc.abstractmethod
    def send_message(self, msg: Message) -> None:
        ...

    @abc.abstractmethod
    def add_observer(self, observer: Observer) -> None:
        ...

    @abc.abstractmethod
    def remove_observer(self, observer: Observer) -> None:
        ...

    @abc.abstractmethod
    def handle_receive_message(self) -> None:
        """Enter the receive loop (blocks until stopped)."""

    @abc.abstractmethod
    def stop_receive_message(self) -> None:
        ...


class InboxCommManager(BaseCommunicationManager):
    """Observers and an inbox: a transport puts each decoded message with
    :meth:`_deliver_local`, and the receive loop hands it to every observer
    on the loop's own thread until :meth:`_stop_inbox`."""

    def __init__(self):
        self._observers: List[Observer] = []
        self._inbox: "queue.Queue[Optional[Message]]" = queue.Queue()
        self._running = False

    def _deliver_local(self, msg: Message) -> None:
        self._inbox.put(msg)

    def add_observer(self, observer: Observer) -> None:
        self._observers.append(observer)

    def remove_observer(self, observer: Observer) -> None:
        if observer in self._observers:
            self._observers.remove(observer)

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            try:
                msg = self._inbox.get(timeout=0.2)
            except queue.Empty:
                continue
            if msg is None:
                break
            for obs in list(self._observers):
                obs.receive_message(msg.get_type(), msg)

    def _stop_inbox(self) -> None:
        self._running = False
        self._inbox.put(None)
