"""Typed parameter bag + global context singleton.

A copy of ``fedml_tpu/core/alg_frame/params.py`` (itself the counterpart of
the FedML reference's ``core/alg_frame/params.py`` / ``context.py``).
"""
from __future__ import annotations

from typing import Any


class Params:
    """Arbitrary keyed parameters passed through algorithm hooks."""

    def __init__(self, **kwargs: Any):
        for k, v in kwargs.items():
            setattr(self, k, v)

    def add(self, name: str, value: Any) -> "Params":
        setattr(self, name, value)
        return self

    def get(self, name: str, default: Any = None) -> Any:
        return getattr(self, name, default)

    def __contains__(self, name: str) -> bool:
        return hasattr(self, name)


class Context(Params):
    """Process-wide singleton context shared across algorithm hooks.

    Reference: ``core/alg_frame/context.py`` — e.g. the per-round client list
    ``KEY_CLIENT_ID_LIST_IN_THIS_ROUND`` consumed by defenses and the
    contribution assessor.
    """

    KEY_TEST_DATA = "test_data"
    KEY_CLIENT_ID_LIST_IN_THIS_ROUND = "client_id_list_in_this_round"
    KEY_CLIENT_NUM_IN_THIS_ROUND = "client_num_in_this_round"
    KEY_METRICS_ON_AGGREGATED_MODEL = "metrics_on_aggregated_model"
    KEY_METRICS_ON_LAST_ROUND = "metrics_on_last_round"
    KEY_CLIENT_CONTRIBUTIONS = "client_contributions"

    _instance: "Context | None" = None

    def __new__(cls) -> "Context":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None
