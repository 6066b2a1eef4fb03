"""Telemetry of the port: the metrics registry and the compression-aware
update norm (``health.update_norm``); spans and the health tracker wait for
ROADMAP A12."""
from fedml_tpu_torch.telemetry.registry import get_registry

__all__ = ["get_registry"]
