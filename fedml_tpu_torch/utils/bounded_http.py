"""Bounded admission for stdlib ``ThreadingHTTPServer`` handlers — the
port's copy of ``fedml_tpu/utils/bounded_http.py``.

A ``ThreadingHTTPServer`` accepts one OS thread per connection, but work
admission is gated by a semaphore permit: a request that cannot get one
within ``queue_wait_s`` is shed at once with ``429`` + ``Retry-After``
instead of queueing without bound behind a saturated engine. Shedding on a
keep-alive (HTTP/1.1) connection drains the unread request body, or the
next request on the socket would be parsed from leftover bytes.
``on_wait`` and ``on_shed`` hooks are best-effort: they never break the
served request.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Callable, Optional

__all__ = ["AdmissionGate", "drain_body"]


def drain_body(handler, max_drain_bytes: int = 1 << 20) -> None:
    """Consume the unread request body before an error reply; bodies past
    ``max_drain_bytes`` close the connection instead."""
    n = int(handler.headers.get("Content-Length", 0))
    if n > max_drain_bytes:
        handler.close_connection = True
    elif n > 0:
        handler.rfile.read(n)


class AdmissionGate:
    """Permit pool + queue-wait measurement + the 429 shed path.

    ``admit(handler)`` returns True and charges one permit (release with
    :meth:`release`), or writes the full 429 response — body drained,
    ``Retry-After: 1`` — and returns False.
    """

    def __init__(self, max_inflight: int, queue_wait_s: float,
                 max_drain_bytes: int = 1 << 20,
                 on_wait: Optional[Callable[[float], None]] = None,
                 on_shed: Optional[Callable[[int, float], None]] = None):
        self._permits = threading.BoundedSemaphore(int(max_inflight))
        self._queue_wait_s = float(queue_wait_s)
        self._max_drain_bytes = int(max_drain_bytes)
        self._on_wait = on_wait
        self._on_shed = on_shed
        self._waiting = 0
        self._lock = threading.Lock()

    @property
    def waiting(self) -> int:
        """Callers currently blocked on a permit."""
        with self._lock:
            return self._waiting

    def admit(self, handler) -> bool:
        t0 = time.perf_counter()
        with self._lock:
            self._waiting += 1
        try:
            ok = self._permits.acquire(timeout=self._queue_wait_s)
        finally:
            with self._lock:
                self._waiting -= 1
        wait_s = time.perf_counter() - t0
        if self._on_wait is not None:
            try:
                self._on_wait(wait_s)
            except Exception:  # noqa: BLE001 - hooks are best-effort
                pass
        if ok:
            return True
        depth = self.waiting
        drain_body(handler, self._max_drain_bytes)
        if self._on_shed is not None:
            try:
                self._on_shed(depth, wait_s)
            except Exception:  # noqa: BLE001 - hooks are best-effort
                pass
        body = json.dumps({"error": "overloaded"}).encode()
        try:
            handler.send_response(429)
            handler.send_header("Retry-After", "1")
            handler.send_header("Content-Type", "application/json")
            handler.send_header("Content-Length", str(len(body)))
            handler.end_headers()
            handler.wfile.write(body)
        except BrokenPipeError:  # pragma: no cover - client gone
            pass
        return False

    def release(self) -> None:
        self._permits.release()
