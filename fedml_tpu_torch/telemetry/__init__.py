"""Telemetry of the port: the typed metrics registry, trace-propagating
spans, the flight recorder and the run report (ROADMAP A12a, the
counterpart of ``fedml_tpu.telemetry``'s span layer), and the
compression-aware update norm (``health.update_norm``).

    from fedml_tpu_torch import telemetry

    reg = telemetry.get_registry()
    reg.counter("broker/bytes_in").inc(1024)

    tracer = telemetry.configure(".fedml_logs/run_0", service="sp")
    with tracer.span("round/0/train"):
        ...  # child spans and remote contexts stitch automatically
    telemetry.flush_run()  # spans.jsonl + telemetry.jsonl in the run dir

``python -m fedml_tpu_torch.cli telemetry report <run_dir>`` reads a run
dir. The program catalog, the roofline, device traces, device stats, the
client health tracker and ``doctor`` wait for ROADMAP A12b; causal
tracing and the live plane for A12c.
"""
from fedml_tpu_torch.telemetry.registry import (
    BYTES_BUCKETS,
    DEFAULT_BUCKETS_MS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    get_registry,
    reset_registry,
    set_registry,
)
from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.flight_recorder import (
    FlightRecorder,
    get_flight_recorder,
    reset_flight_recorder,
)
from fedml_tpu_torch.telemetry.spans import (
    CTX_KEY,
    TraceContext,
    Tracer,
    activate_context,
    add_span_listener,
    configure,
    configure_from_args,
    current_context,
    deactivate_context,
    extract_context,
    flush_run,
    get_tracer,
    inject_context,
    note_kernel_build,
    remove_span_listener,
    reset_tracer,
    unwrap_frame_body,
    wrap_frame_body,
)
from fedml_tpu_torch.telemetry.report import (
    RunData,
    build_report,
    format_report,
    load_metrics,
    load_programs,
    load_spans,
)

__all__ = [
    "BYTES_BUCKETS",
    "DEFAULT_BUCKETS_MS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "reset_registry",
    "set_registry",
    "CTX_KEY",
    "TraceContext",
    "Tracer",
    "activate_context",
    "add_span_listener",
    "configure",
    "configure_from_args",
    "current_context",
    "deactivate_context",
    "extract_context",
    "flush_run",
    "get_tracer",
    "inject_context",
    "note_kernel_build",
    "remove_span_listener",
    "reset_tracer",
    "unwrap_frame_body",
    "wrap_frame_body",
    "RunData",
    "build_report",
    "format_report",
    "load_metrics",
    "load_programs",
    "load_spans",
    "flight_recorder",
    "FlightRecorder",
    "get_flight_recorder",
    "reset_flight_recorder",
]
