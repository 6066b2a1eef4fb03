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
dir. Device-side profiling (ROADMAP A12b1) is here too: the program
catalog (``wrap_program``, ``programs.jsonl``), the H100 roofline and the
report's attribution, ``torch.profiler`` round traces
(``TraceController``) and phase-attributed device memory samples
(``DeviceStatsSampler``, ``mem_sample`` records in ``health.jsonl``). So
is run health (A12b2): the per-client straggler and anomaly scoring
(``ClientHealthTracker``, ``client_health`` records), the resilience,
secagg, integrity and scheduler records, and ``build_doctor`` /
``format_doctor`` behind ``telemetry doctor <run_dir>``. Causal tracing
and the live plane (A12c) are ``tracing`` (clock alignment, the assembled
trace, the per-round critical path, Perfetto export, span streams) and
``live`` (metric frames, the collector, the online doctor, ``/metrics``,
``watch``; ``LivePlane`` ties them together), read with ``telemetry trace``
and ``telemetry watch``.
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
from fedml_tpu_torch.telemetry.device_stats import (
    DeviceStatsSampler,
    install_compile_cache_counters,
    memory_snapshot,
    sample_now,
)
from fedml_tpu_torch.telemetry.health import (
    ClientHealthTracker,
    log_health_event,
    update_norm,
)
from fedml_tpu_torch.telemetry.profiling import (
    ProgramCatalog,
    TraceController,
    get_catalog,
    get_trace_controller,
    reset_catalog,
    reset_trace_controller,
    wrap_program,
)
from fedml_tpu_torch.telemetry.report import (
    RunData,
    build_report,
    format_report,
    load_metrics,
    load_programs,
    load_spans,
)
from fedml_tpu_torch.telemetry.doctor import build_doctor, format_doctor
from fedml_tpu_torch.telemetry.live import (
    LiveCollector,
    LivePlane,
    MetricStreamer,
    MetricsScrapeServer,
    OnlineDoctor,
    reset_live_plane,
)
from fedml_tpu_torch.telemetry.tracing import (
    AssembledTrace,
    RoundCriticalPath,
    SpanStreamer,
    TraceCollector,
    assemble_trace,
    compute_critical_path,
    compute_critical_paths,
    export_perfetto,
    summarize_critical_paths,
    write_perfetto,
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
    "build_doctor",
    "format_doctor",
    "LiveCollector",
    "LivePlane",
    "MetricStreamer",
    "MetricsScrapeServer",
    "OnlineDoctor",
    "reset_live_plane",
    "AssembledTrace",
    "RoundCriticalPath",
    "SpanStreamer",
    "TraceCollector",
    "assemble_trace",
    "compute_critical_path",
    "compute_critical_paths",
    "export_perfetto",
    "summarize_critical_paths",
    "write_perfetto",
    "ClientHealthTracker",
    "DeviceStatsSampler",
    "install_compile_cache_counters",
    "memory_snapshot",
    "sample_now",
    "log_health_event",
    "update_norm",
    "ProgramCatalog",
    "TraceController",
    "get_catalog",
    "get_trace_controller",
    "reset_catalog",
    "reset_trace_controller",
    "wrap_program",
    "flight_recorder",
    "FlightRecorder",
    "get_flight_recorder",
    "reset_flight_recorder",
]
