"""FedMLInferenceRunner — HTTP wrapper around a FedMLPredictor
(counterpart of ``fedml_tpu/serving/inference_runner.py``), on the stdlib
``ThreadingHTTPServer``:

  POST /predict      JSON request → JSON response; an iterator result
                     streams newline-delimited JSON (chunked encoding)
  GET  /ready        {"ready": bool, ...endpoint monitor snapshot}
  GET  /metrics      Prometheus exposition of the port's registry

Predictor admission is bounded (``max_inflight``): a request that cannot
get a permit within ``queue_wait_s`` is shed with ``429`` + ``Retry-After``.
Every request is recorded in the EndpointMonitor. The OpenAI-compatible
surface and the ``serving/request`` spans wait for the ROADMAP (A7, A12).
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from fedml_tpu_torch.serving.monitor import EndpointMonitor
from fedml_tpu_torch.serving.predictor import FedMLPredictor
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.bounded_http import AdmissionGate


class FedMLInferenceRunner:
    def __init__(
        self,
        predictor: FedMLPredictor,
        host: str = "127.0.0.1",
        port: int = 0,
        monitor: Optional[EndpointMonitor] = None,
        max_inflight: int = 64,
        queue_wait_s: float = 0.05,
    ):
        self.predictor = predictor
        self.monitor = monitor or EndpointMonitor()
        self._gate = AdmissionGate(
            max_inflight, queue_wait_s,
            on_wait=lambda s: self.monitor.record_queue_wait(s * 1e3),
            on_shed=lambda depth, _s: self.monitor.record_rejected(depth))
        runner = self

        class Handler(BaseHTTPRequestHandler):
            # chunked transfer encoding only exists in HTTP/1.1
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):  # quiet
                pass

            def _send_body(self, body: bytes, content_type: str,
                           status: int = 200) -> None:
                self.send_response(status)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _send_json(self, obj, status: int = 200) -> None:
                self._send_body(json.dumps(obj).encode(), "application/json",
                                status)

            def do_GET(self):
                path = self.path.rstrip("/")
                if path in ("", "/ready", "/health", "/healthz"):
                    self._send_json({"ready": bool(runner.predictor.ready()),
                                     **runner.monitor.snapshot()})
                elif path == "/metrics":
                    self._send_body(get_registry().export_prometheus().encode(),
                                    "text/plain; version=0.0.4; charset=utf-8")
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path.rstrip("/") != "/predict":
                    self.send_error(404)
                    return
                if not runner._gate.admit(self):
                    return  # shed with 429 (body drained)
                t0 = time.time()
                ok = False
                try:
                    ok = self._serve_predict()
                finally:
                    runner._gate.release()
                    runner.monitor.record_request(time.time() - t0, ok)

            def _serve_predict(self) -> bool:
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    request = json.loads(self.rfile.read(n) or b"{}")
                    result = runner.predictor.predict(request)
                    if hasattr(result, "__next__"):  # streaming
                        self.send_response(200)
                        self.send_header("Content-Type", "application/x-ndjson")
                        self.send_header("Transfer-Encoding", "chunked")
                        self.end_headers()
                        for chunk in result:
                            data = (json.dumps(chunk) + "\n").encode()
                            self.wfile.write(f"{len(data):x}\r\n".encode()
                                             + data + b"\r\n")
                        self.wfile.write(b"0\r\n\r\n")
                    else:
                        self._send_json(result)
                    return True
                except BrokenPipeError:
                    return False
                except Exception as e:  # predictor errors → 500 + message
                    try:
                        self._send_json({"error": str(e)}, status=500)
                    except BrokenPipeError:
                        pass
                    return False

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> "FedMLInferenceRunner":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def run(self) -> None:
        """Blocking variant: serve until interrupted."""
        self._server.serve_forever()

    def stop(self) -> None:
        # shutdown() waits for a serve_forever loop, so only for start()'s
        if self._thread is not None:
            self._server.shutdown()
            self._thread.join(timeout=5)
            self._thread = None
        self._server.server_close()
