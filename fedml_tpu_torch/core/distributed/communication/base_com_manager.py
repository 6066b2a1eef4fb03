"""BaseCommunicationManager and Observer — counterpart of
``fedml_tpu/core/distributed/communication/base_com_manager.py``: the seam
every transport implements; the FSMs never see transport details."""
from __future__ import annotations

import abc

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
