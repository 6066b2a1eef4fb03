"""Telemetry of the port: the metrics registry (spans wait for ROADMAP A12)."""
from fedml_tpu_torch.telemetry.registry import get_registry

__all__ = ["get_registry"]
