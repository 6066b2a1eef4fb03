"""The MLOps facades of the port (counterpart of ``fedml_tpu/core/mlops``):
the profiler-event spans over the telemetry tracer, the local metrics sink,
the run-status machine, the log daemon and the system-stats sampler."""
from fedml_tpu_torch.core.mlops.event import MLOpsProfilerEvent
from fedml_tpu_torch.core.mlops.metrics import MLOpsMetrics, log, log_metric

__all__ = ["MLOpsProfilerEvent", "MLOpsMetrics", "log", "log_metric"]
