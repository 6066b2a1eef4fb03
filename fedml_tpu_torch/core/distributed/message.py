"""Typed message — counterpart of ``fedml_tpu/core/distributed/message.py``.

The unit of federation-plane communication: a type, a sender, a receiver
and a params dict, with the reference's keys, so a port peer and a JAX peer
read each other's messages. Model payloads stay tensors on the device
until a transport needs bytes (``utils/serialization.py``).
"""
from __future__ import annotations

from typing import Any, Dict


class Message:
    MSG_ARG_KEY_OPERATION = "operation"
    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"

    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_MODEL_PARAMS_URL = "model_params_url"
    MSG_ARG_KEY_MODEL_PARAMS_KEY = "model_params_key"
    # negotiation header: the codec spec the receiver uses for its uploads
    MSG_ARG_KEY_COMPRESSION = "compression"
    # negotiation header: the robust-aggregation spec of the round
    MSG_ARG_KEY_AGG_ROBUST = "agg_robust"
    # piggybacked health fields (JSON-safe scalars: train wall, train loss,
    # memory bytes) on status and upload messages
    MSG_ARG_KEY_HEALTH = "health"
    # idempotent-send header, stamped once per logical message
    MSG_ARG_KEY_MSG_ID = "msg_id"
    # rejoin marker on a resync after an eviction
    MSG_ARG_KEY_REJOIN = "rejoin"
    # live telemetry: one seq-numbered metric frame (a JSON-safe dict,
    # telemetry/live/frames.py) piggybacked on a message already sent
    MSG_ARG_KEY_TELEMETRY = "telemetry_frame"
    # causal tracing: one seq-numbered span-batch frame
    # (telemetry/tracing/stream.py), piggybacked the same way
    MSG_ARG_KEY_TRACE = "trace_frame"

    def __init__(self, type_: str = "default", sender_id: int = 0, receiver_id: int = 0):
        self.type = str(type_)
        self.sender_id = int(sender_id)
        self.receiver_id = int(receiver_id)
        self.msg_params: Dict[str, Any] = {
            Message.MSG_ARG_KEY_TYPE: self.type,
            Message.MSG_ARG_KEY_SENDER: self.sender_id,
            Message.MSG_ARG_KEY_RECEIVER: self.receiver_id,
        }

    def get_sender_id(self) -> int:
        return self.sender_id

    def get_receiver_id(self) -> int:
        return self.receiver_id

    def get_type(self) -> str:
        return self.type

    def add_params(self, key: str, value: Any) -> "Message":
        self.msg_params[key] = value
        return self

    def get_params(self) -> Dict[str, Any]:
        return self.msg_params

    def get(self, key: str, default: Any = None) -> Any:
        return self.msg_params.get(key, default)

    @classmethod
    def construct_from_params(cls, params: Dict[str, Any]) -> "Message":
        msg = cls(
            params.get(cls.MSG_ARG_KEY_TYPE, "default"),
            params.get(cls.MSG_ARG_KEY_SENDER, 0),
            params.get(cls.MSG_ARG_KEY_RECEIVER, 0),
        )
        msg.msg_params.update(params)
        return msg

    def __repr__(self) -> str:  # pragma: no cover
        keys = [k for k in self.msg_params if k not in (
            self.MSG_ARG_KEY_TYPE, self.MSG_ARG_KEY_SENDER, self.MSG_ARG_KEY_RECEIVER)]
        return (f"Message(type={self.type}, {self.sender_id}->{self.receiver_id}, "
                f"keys={keys})")
