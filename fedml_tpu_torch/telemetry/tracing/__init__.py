"""Causal round tracing — the port's copy of ``fedml_tpu/telemetry/tracing``:
assembly, clock alignment, critical path.

The federation writes spans per process; this package joins them into one
happens-before-ordered timeline (:mod:`.assemble`), places every node's
clock on the reference timeline with an explicit uncertainty bound
(:mod:`.clock`), extracts and attributes each round's critical path
(:mod:`.critical_path`), streams span batches over the live plane for
distributed runs (:mod:`.stream`), and exports Perfetto/Chrome
trace-event JSON (:mod:`.perfetto`).
"""
from fedml_tpu_torch.telemetry.tracing.assemble import (
    REMOTE_SPANS_FILENAME,
    AssembledTrace,
    TraceSpan,
    assemble_records,
    assemble_trace,
    load_trace_records,
)
from fedml_tpu_torch.telemetry.tracing.clock import NodeClock, align_clocks
from fedml_tpu_torch.telemetry.tracing.critical_path import (
    RoundCriticalPath,
    Segment,
    compute_critical_path,
    compute_critical_paths,
    phase_of,
    summarize_critical_paths,
)
from fedml_tpu_torch.telemetry.tracing.perfetto import (
    export_perfetto,
    write_perfetto,
)
from fedml_tpu_torch.telemetry.tracing.stream import (
    PHASE_CODES,
    SpanStreamer,
    TraceCollector,
    phase_code,
    phase_label,
)

__all__ = [
    "REMOTE_SPANS_FILENAME",
    "AssembledTrace",
    "TraceSpan",
    "assemble_records",
    "assemble_trace",
    "load_trace_records",
    "NodeClock",
    "align_clocks",
    "RoundCriticalPath",
    "Segment",
    "compute_critical_path",
    "compute_critical_paths",
    "phase_of",
    "summarize_critical_paths",
    "export_perfetto",
    "write_perfetto",
    "PHASE_CODES",
    "SpanStreamer",
    "TraceCollector",
    "phase_code",
    "phase_label",
]
