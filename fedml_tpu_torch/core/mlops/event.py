"""Profiler events — a thin facade over the telemetry tracer.

Counterpart of ``fedml_tpu/core/mlops/event.py`` (the reference's
``log_event_started`` / ``log_event_ended`` by name and edge id). The
records are the tracer's, in ``<log_file_dir>/run_<run_id>/events.jsonl``.
An end without a start is an explicit zero-duration record marked
``unmatched``, never a span that pretends to have started just then. The
buffer lands on disk when it reaches ``flush_threshold`` records, on
``flush()`` and at exit, so a run that never reaches ``flush()`` loses at
most the buffer's tail. ``sys_perf_profiling: false`` turns the events
off.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

from fedml_tpu_torch.telemetry.spans import Tracer


class MLOpsProfilerEvent:
    def __init__(self, args: Any = None, sink_path: Optional[str] = None,
                 flush_threshold: int = 512):
        self.enabled = bool(getattr(args, "sys_perf_profiling", True)) if args else True
        run_id = str(getattr(args, "run_id", "0")) if args else "0"
        base = sink_path or os.path.join(
            str(getattr(args, "log_file_dir", "") or ".fedml_logs"), f"run_{run_id}")
        self._dir = base
        self._lock = threading.Lock()
        self._open_spans: Dict[Tuple[str, Any], Any] = {}
        self._tracer = Tracer(sink_dir=base, filename="events.jsonl",
                              buffer_limit=max(int(flush_threshold), 1))
        self._trace_dir = getattr(args, "jax_trace_dir", None) if args else None

    def log_event_started(self, event_name: str, event_edge_id: Any = 0) -> None:
        if not self.enabled:
            return
        span = self._tracer.begin(f"event/{event_name}", edge_id=event_edge_id)
        with self._lock:
            self._open_spans[(event_name, event_edge_id)] = span

    def log_event_ended(self, event_name: str, event_edge_id: Any = 0) -> None:
        if not self.enabled:
            return
        now = time.time()
        with self._lock:
            span = self._open_spans.pop((event_name, event_edge_id), None)
        if span is None:
            span = self._tracer.begin(f"event/{event_name}", edge_id=event_edge_id,
                                      unmatched=True)
            span.started = now
        self._tracer.end(span, ended=now)

    def spans(self):
        """Buffered (not yet flushed) spans in the reference's record shape."""
        out = []
        for rec in self._tracer.records():
            attrs = rec.get("attrs", {})
            out.append({
                "event": rec["name"].split("/", 1)[-1],
                "edge_id": attrs.get("edge_id", 0),
                "started": rec["started"],
                "ended": rec["ended"],
                "duration_ms": 0.0 if attrs.get("unmatched") else rec["duration_ms"],
            })
        return out

    def flush(self) -> Optional[str]:
        return self._tracer.flush()

    # manual device traces go through the one budgeted trace controller
    # that ``telemetry profile`` and the round hooks also use
    def start_trace(self) -> bool:
        if not self._trace_dir:
            return False
        from fedml_tpu_torch.telemetry.profiling import get_trace_controller

        return get_trace_controller().start_manual(self._trace_dir)

    def stop_trace(self):
        if not self._trace_dir:
            return None
        from fedml_tpu_torch.telemetry.profiling import get_trace_controller

        return get_trace_controller().stop_manual()
