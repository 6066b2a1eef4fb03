"""Live ``/metrics`` scrape endpoint for a collector (the port's copy of
``fedml_tpu/telemetry/live/scrape.py``).

The same bounded ``ThreadingHTTPServer`` pattern as the serving
runner (one OS thread per connection, but admission gated by a semaphore
that sheds with 429 instead of queueing unboundedly), serving:

- ``GET /metrics``      Prometheus text: the collector's node-/job-
                        labeled aggregate + this process's ``live/*``
                        plane health (frames, gaps, alerts);
- ``GET /metrics.json`` machine-readable state: per-node seq/gap
                        accounting, the merged metric snapshot, and the
                        online doctor's alerts (what ``telemetry watch``
                        renders);
- ``GET /healthz``      liveness + plane stats;
- ``POST /ingest``      one JSON metric frame — the dedicated-transport
                        path for nodes with no federation traffic to
                        piggyback on (a serving endpoint, a scheduler).
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from fedml_tpu_torch.telemetry.registry import get_registry
from fedml_tpu_torch.utils.bounded_http import AdmissionGate, drain_body

__all__ = ["MetricsScrapeServer"]

_MAX_FRAME_BYTES = 4 << 20  # a POSTed frame larger than this is garbage


class MetricsScrapeServer:
    def __init__(self, collector, host: str = "127.0.0.1", port: int = 0,
                 doctor=None, max_inflight: int = 8,
                 queue_wait_s: float = 0.05):
        self.collector = collector
        self.doctor = doctor
        server = self
        reg = get_registry()
        self._m_scrapes = reg.counter("live/scrapes")
        self._m_rejected = reg.counter("live/scrapes_rejected")
        # shared bounded-admission policy (same gate as the inference
        # runner); a shed scrape only bumps the counter — the live plane
        # has no per-request latency story to tell
        self._gate = AdmissionGate(
            max_inflight, queue_wait_s, max_drain_bytes=_MAX_FRAME_BYTES,
            on_shed=lambda depth, wait_s: self._m_rejected.inc())

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send(self, body: bytes, status: int = 200,
                      ctype: str = "application/json") -> None:
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if not server._gate.admit(self):
                    return
                try:
                    path = self.path.split("?")[0].rstrip("/")
                    if path == "/metrics":
                        server._m_scrapes.inc()
                        text = server.collector.export_prometheus()
                        self._send(text.encode(), ctype="text/plain; "
                                   "version=0.0.4; charset=utf-8")
                    elif path == "/metrics.json":
                        server._m_scrapes.inc()
                        self._send(json.dumps(
                            server.state(), default=str).encode())
                    elif path in ("", "/healthz", "/health"):
                        self._send(json.dumps(
                            {"ok": True, **server.collector.stats()}).encode())
                    else:
                        self.send_error(404)
                except BrokenPipeError:  # pragma: no cover - client gone
                    pass
                finally:
                    server._gate.release()

            def do_POST(self):
                if not server._gate.admit(self):
                    return
                try:
                    path = self.path.rstrip("/")
                    n = int(self.headers.get("Content-Length", 0))
                    if path != "/ingest":
                        drain_body(self, _MAX_FRAME_BYTES)
                        self.send_error(404)
                        return
                    if n <= 0 or n > _MAX_FRAME_BYTES:
                        drain_body(self, _MAX_FRAME_BYTES)
                        self._send(json.dumps(
                            {"error": "bad frame size"}).encode(), status=400)
                        return
                    try:
                        frame = json.loads(self.rfile.read(n))
                    except ValueError:
                        self._send(json.dumps(
                            {"error": "not json"}).encode(), status=400)
                        return
                    applied = server.collector.ingest(frame)
                    self._send(json.dumps({"applied": bool(applied)}).encode())
                except BrokenPipeError:  # pragma: no cover
                    pass
                finally:
                    server._gate.release()

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    def state(self) -> dict:
        """The ``/metrics.json`` payload (also what watch renders)."""
        return {
            **self.collector.stats(),
            "nodes_detail": self.collector.nodes(),
            "metrics": self.collector.snapshot(),
            "alerts": (self.doctor.snapshot()[-32:]
                       if self.doctor is not None else []),
        }

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> "MetricsScrapeServer":
        if self._thread is None:
            self._thread = threading.Thread(
                # 50ms poll: the default 0.5s makes shutdown() block up
                # to half a second INSIDE a closing run's wall clock —
                # measured as a fake 20% rounds/s hit on short runs
                target=lambda: self._server.serve_forever(
                    poll_interval=0.05),
                daemon=True, name="metrics-scrape")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
