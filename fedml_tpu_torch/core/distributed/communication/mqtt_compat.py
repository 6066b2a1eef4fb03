"""The pub/sub client seam of the broker transport — counterpart of
``fedml_tpu/core/distributed/communication/mqtt_compat.py``.

:class:`PubSubClient` is the contract ``BrokerCommManager`` needs; two
clients implement it on the same topic scheme (``fedml/<run_id>/<rank>``)
and binary payloads, so a federation's wire does not change with the
transport:

- :class:`TcpBrokerClient`, the in-tree broker's client (``broker_protocol:
  tcp``, the default; no dependency), which re-dials a lost broker;
- :class:`PahoMqttClient`, the same contract over ``paho-mqtt`` against a
  real MQTT broker (``broker_protocol: mqtt``, and ``comm_backend:
  MQTT_S3``). Constructing it without paho raises ``RuntimeError`` with
  instructions; importing this module does not need paho.
"""
from __future__ import annotations

import threading
import uuid
from typing import Callable

from fedml_tpu_torch.core.distributed.communication.broker import BrokerClient


class PubSubClient:
    """``subscribe(topic, handler)``, ``publish(topic, body)``, ``close()``.
    Handlers run on a background thread, and publishes may be concurrent."""

    def subscribe(self, topic: str, handler: Callable[[bytes], None]) -> None:
        raise NotImplementedError

    def publish(self, topic: str, body: bytes) -> None:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class TcpBrokerClient(PubSubClient):
    """The in-tree broker's client behind the contract (Python or C++
    broker: one frame protocol). The frame envelope is off, as in the
    reference: comm messages carry their context in the ``telemetry_ctx``
    header already."""

    def __init__(self, host: str, port: int, **_):
        self._client = BrokerClient(host, port, propagate_trace=False)

    def subscribe(self, topic, handler):
        self._client.subscribe(topic, handler)

    def publish(self, topic, body):
        self._client.publish(topic, body)

    def close(self):
        self._client.close()


class PahoMqttClient(PubSubClient):
    """paho-mqtt behind the contract, at the reference's QoS 2."""

    def __init__(self, host: str, port: int = 1883, qos: int = 2, client_id: str = "",
                 username: str = "", password: str = "", keepalive: int = 180):
        try:
            import paho.mqtt.client as mqtt
        except ImportError as e:
            raise RuntimeError(
                "broker_protocol: mqtt requires paho-mqtt (pip install paho-mqtt); the "
                "in-tree 'tcp' protocol needs no dependencies") from e
        self.qos = int(qos)
        self._handlers = {}
        self._lock = threading.Lock()
        self._connected = threading.Event()
        cid = client_id or f"fedml-tpu-{uuid.uuid4().hex[:8]}"
        if hasattr(mqtt, "CallbackAPIVersion"):  # paho-mqtt >= 2.0
            self._client = mqtt.Client(mqtt.CallbackAPIVersion.VERSION1, client_id=cid)
        else:
            self._client = mqtt.Client(client_id=cid, clean_session=True)
        if username:
            self._client.username_pw_set(username, password)
        self._client.on_connect = self._on_connect
        self._client.on_message = self._on_message
        self._client.connect(host, int(port), keepalive)
        self._client.loop_start()
        if not self._connected.wait(timeout=30):
            self._client.loop_stop()
            raise TimeoutError(f"MQTT broker {host}:{port} unreachable")

    def _on_connect(self, client, userdata, flags, rc, *a):
        self._connected.set()
        with self._lock:  # resubscribe after a reconnect
            for topic in self._handlers:
                client.subscribe(topic, qos=self.qos)

    def _on_message(self, client, userdata, msg):
        with self._lock:
            handler = self._handlers.get(msg.topic)
        if handler is not None:
            handler(msg.payload)

    def subscribe(self, topic, handler):
        with self._lock:
            self._handlers[topic] = handler
        self._client.subscribe(topic, qos=self.qos)

    def publish(self, topic, body):
        self._client.publish(topic, body, qos=self.qos)

    def close(self):
        self._client.loop_stop()
        self._client.disconnect()


PROTOCOLS = {"tcp": TcpBrokerClient, "mqtt": PahoMqttClient}


def create_pubsub_client(protocol: str, host: str, port: int, **kwargs) -> PubSubClient:
    """The client ``protocol`` names (``tcp`` or ``mqtt``); an unknown name
    raises ``ValueError``."""
    key = str(protocol or "tcp").lower()
    if key not in PROTOCOLS:
        raise ValueError(f"unknown broker_protocol {protocol!r}; choose from "
                         f"{sorted(PROTOCOLS)}")
    return PROTOCOLS[key](host, port, **kwargs)
