"""Live telemetry plane — the port's copy of ``fedml_tpu/telemetry/live``:
stream metrics and spans while the run is in flight.

The run-dir sinks that ``telemetry report`` and ``doctor`` read are
post-hoc. This package makes telemetry **live**: a node (a cross-silo
client in its own process, the tree root) snapshots its metric registry
off-thread and streams seq-numbered cumulative-delta frames to a central
:class:`LiveCollector`, piggybacked on round traffic
(``FedMLCommManager`` pops a prepared frame onto outgoing messages). The
collector merges frames into a node-/job-labeled aggregate registry with
duplicate-frame idempotence and seq-gap accounting, serves it on a live
``/metrics`` Prometheus scrape endpoint (+ ``/healthz``), and powers
``python -m fedml_tpu_torch.cli telemetry watch`` plus the
:class:`OnlineDoctor` — the post-hoc triage rules evaluated mid-run,
alerting at the round a condition trips instead of in the autopsy. Span
frames ride beside the metric frames (``tracing.SpanStreamer``), so the
collector host assembles the federation's causal trace and lands it as
``spans_remote.jsonl``.

Enable on a cross-silo federation with ``live_telemetry: true`` (plus an
optional ``metrics_port``, ``trace_streaming`` and ``live_interval_s``) in
the train args, or pass ``TreeRunner(live=LivePlane(...))``. The frames
are the reference's, so either package's collector merges the other's.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from fedml_tpu_torch.telemetry.live.collector import LiveCollector
from fedml_tpu_torch.telemetry.live.frames import (
    FRAME_VERSION,
    MetricStreamer,
    frame_nbytes,
)
from fedml_tpu_torch.telemetry.live.online_doctor import OnlineDoctor
from fedml_tpu_torch.telemetry.live.scrape import MetricsScrapeServer
from fedml_tpu_torch.telemetry.live.watch import fetch_state, render_state, watch

__all__ = [
    "FRAME_VERSION",
    "LiveCollector",
    "LivePlane",
    "MetricStreamer",
    "MetricsScrapeServer",
    "OnlineDoctor",
    "current_live_plane",
    "fetch_state",
    "frame_nbytes",
    "ingest_frame",
    "ingest_trace_frame",
    "render_state",
    "reset_live_plane",
    "watch",
]

_plane_lock = threading.Lock()
_plane: Optional["LivePlane"] = None


class LivePlane:
    """The collector-side bundle one process hosts: loopback streamer for
    its own registry, the collector, the online doctor, and (optionally)
    the HTTP scrape endpoint. Construct via :meth:`from_args` on whatever
    node aggregates the run (the cross-silo server, the tree root, a
    scheduler) — remote frames arriving at ANY comm manager in this
    process are routed here via :func:`ingest_frame`."""

    def __init__(self, job: str, node: str = "rank0",
                 run_dir: Optional[str] = None,
                 metrics_port: Optional[int] = None,
                 metrics_host: str = "127.0.0.1",
                 interval_s: float = 1.0,
                 doctor_kwargs: Optional[Dict[str, Any]] = None,
                 tracing: bool = True):
        self.collector = LiveCollector(job=job)
        self.doctor = OnlineDoctor(self.collector, run_dir=run_dir,
                                   **(doctor_kwargs or {}))
        self.streamer = MetricStreamer(node, job=job,
                                       interval_s=interval_s).start()
        self._run_dir = run_dir
        # causal tracing: merge span-batch frames from every node (and
        # this process's own spans via a loopback SpanStreamer) so the
        # per-round critical path is computable while the run is live,
        # and the merged set persists as spans_remote.jsonl on close
        self.trace_collector = None
        self.trace_streamer = None
        if tracing:
            from fedml_tpu_torch.telemetry.tracing import (
                SpanStreamer,
                TraceCollector,
            )

            self.trace_collector = TraceCollector(job=job)
            self.trace_streamer = SpanStreamer(
                node, job=job, interval_s=interval_s).attach()
        self.scrape: Optional[MetricsScrapeServer] = None
        if metrics_port is not None:
            self.scrape = MetricsScrapeServer(
                self.collector, host=metrics_host, port=int(metrics_port),
                doctor=self.doctor).start()
        self._closed = False
        global _plane
        with _plane_lock:
            _plane = self

    @classmethod
    def from_args(cls, args: Any, node: str,
                  run_dir: Optional[str] = None) -> Optional["LivePlane"]:
        """None unless ``args.live_telemetry`` is truthy — the production
        hot path stays a None-check."""
        if not bool(getattr(args, "live_telemetry", False)):
            return None
        port = getattr(args, "metrics_port", None)
        return cls(
            job=str(getattr(args, "run_id", "0") or "0"),
            node=node,
            run_dir=run_dir,
            metrics_port=int(port) if port is not None else None,
            metrics_host=str(getattr(args, "metrics_host", "127.0.0.1")),
            interval_s=float(getattr(args, "live_interval_s", 1.0)),
            doctor_kwargs={
                "straggler_threshold": float(
                    getattr(args, "straggler_threshold", 2.0)),
                "anomaly_threshold": float(
                    getattr(args, "anomaly_threshold", 4.0)),
            },
            tracing=bool(getattr(args, "trace_streaming", True)),
        )

    @property
    def url(self) -> Optional[str]:
        return self.scrape.url if self.scrape is not None else None

    def pump(self, round_idx: Optional[int] = None) -> None:
        """Loopback this process's own registry into the collector (the
        server calls this once per closed round; rounds are derived from
        the pumped health/rounds_scored metric). With ``round_idx`` and
        tracing enabled, also compute the just-closed round's critical
        path from the merged span set and publish it as ``tracepath/*``
        gauges (the ``telemetry watch`` critical-phase column)."""
        if self.trace_streamer is not None:
            self.trace_streamer.pump(self.trace_collector, force=True)
        if round_idx is not None and self.trace_collector is not None:
            try:
                self._pump_critical_path(int(round_idx))
            except Exception:  # observability must never break the round
                import logging

                logging.getLogger(__name__).exception(
                    "critical-path pump failed at round %s", round_idx)
        self.streamer.pump(self.collector, force=True)

    def _pump_critical_path(self, round_idx: int) -> None:
        from fedml_tpu_torch.telemetry.registry import get_registry
        from fedml_tpu_torch.telemetry.tracing import (
            assemble_records,
            compute_critical_path,
            phase_code,
        )

        trace = assemble_records(self.trace_collector.records())
        cp = compute_critical_path(trace, round_idx)
        if cp is None or not cp.segments:
            return
        reg = get_registry()
        reg.gauge("tracepath/critical_round").set(float(cp.round))
        reg.gauge("tracepath/critical_phase").set(
            float(phase_code(cp.top_phase())))
        reg.gauge("tracepath/critical_share").set(float(cp.top_share()))

    def close(self, drain_s: float = 3.0) -> None:
        """Final full loopback frame, then stop the plane's threads. The
        scrape endpoint keeps serving until stop — callers that want the
        endpoint to outlive the run simply don't close."""
        if self._closed:
            return
        self._closed = True
        # bounded drain: on distributed backends the server's FINISH is
        # what makes each client flush its final FULL frame — those
        # frames are still in flight when the training loop reaches
        # close, and tearing down now would drop them (totals would
        # never become exact). Wait for the stream to go quiet, bounded
        # by drain_s; runs where only the loopback node ever streamed
        # (in-proc LOCAL) have nothing in flight and skip the wait.
        if drain_s > 0 and any(n != self.streamer.node
                               for n in self.collector.nodes()):
            deadline = time.time() + drain_s
            last_count = self.collector.stats()["frames"]
            last_change = time.time()
            while time.time() < deadline:
                time.sleep(0.05)
                count = self.collector.stats()["frames"]
                if count != last_count:
                    last_count, last_change = count, time.time()
                elif time.time() - last_change >= 0.25:
                    break
        # span stream closes FIRST: its close/ingest bump tracepath/*
        # counters in the process registry, and the final metric FULL
        # frame below must snapshot those totals — the other order
        # leaves the collector's mirror permanently short of post-hoc
        if self.trace_streamer is not None:
            tfinal = self.trace_streamer.close()
            if tfinal is not None and self.trace_collector is not None:
                self.trace_collector.ingest(tfinal)
        final = self.streamer.close()
        if final is not None:
            self.collector.ingest(final)
        if self.trace_collector is not None and self._run_dir:
            try:
                # the merged federation-wide span set lands next to the
                # local sink for post-hoc assembly (trace CLI / report)
                self.trace_collector.persist(self._run_dir)
            except OSError:  # pragma: no cover - sink dir gone at exit
                pass
        if self.scrape is not None:
            self.scrape.stop()
        global _plane
        with _plane_lock:
            if _plane is self:
                _plane = None


def current_live_plane() -> Optional[LivePlane]:
    with _plane_lock:
        return _plane


def ingest_frame(frame: Any) -> bool:
    """Route a remote node's frame to this process's plane (no-op when no
    plane is bound — the receiving manager need not know whether it is
    the collector host)."""
    plane = current_live_plane()
    if plane is None:
        return False
    return plane.collector.ingest(frame)


def ingest_trace_frame(frame: Any) -> bool:
    """Route a remote node's span-batch frame to this process's plane's
    TraceCollector (no-op when no plane, or tracing is off)."""
    plane = current_live_plane()
    if plane is None or plane.trace_collector is None:
        return False
    return plane.trace_collector.ingest(frame)


def reset_live_plane() -> None:
    """Drop the process-global plane (test isolation)."""
    global _plane
    with _plane_lock:
        plane, _plane = _plane, None
    if plane is not None:
        try:
            if plane.scrape is not None:
                plane.scrape.stop()
            plane.streamer.stop()
            if plane.trace_streamer is not None:
                plane.trace_streamer.stop()
        except Exception:  # pragma: no cover - teardown best effort
            pass
