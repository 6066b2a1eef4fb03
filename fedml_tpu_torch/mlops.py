"""``fedml_tpu_torch.mlops`` — the public observability calls.

Counterpart of ``fedml_tpu/mlops.py`` (the reference's ``mlops.log``,
``log_metric``, ``log_artifact``, ``log_model``, ``log_llm_record`` and
``event`` spans). Everything lands in the local JSONL sink
(``core/mlops/metrics.py``), with optional wandb mirroring.
"""
from __future__ import annotations

import contextlib

from fedml_tpu_torch.core.mlops.event import MLOpsProfilerEvent
from fedml_tpu_torch.core.mlops.metrics import (  # noqa: F401
    init,
    log,
    log_artifact,
    log_llm_record,
    log_metric,
    log_model,
    log_round_info,
)

_event_singleton = None


def _events() -> MLOpsProfilerEvent:
    global _event_singleton
    if _event_singleton is None:
        _event_singleton = MLOpsProfilerEvent(None)
    return _event_singleton


@contextlib.contextmanager
def event(name: str, event_value=None):
    """A span around the block (the reference's ``mlops.event``)."""
    _events().log_event_started(name, event_value)
    try:
        yield
    finally:
        _events().log_event_ended(name, event_value)


__all__ = [
    "event",
    "init",
    "log",
    "log_artifact",
    "log_llm_record",
    "log_metric",
    "log_model",
    "log_round_info",
]
