"""TCP pub/sub broker — counterpart of
``fedml_tpu/core/distributed/communication/broker.py``, on the same frame
protocol, so a port client can use a JAX-hosted broker and the other way
round:

    frame   := u32 len ‖ payload
    payload := op (1 byte: S=subscribe, P=publish) ‖ u16 topic_len ‖ topic
               ‖ body

over TCP with MQTT semantics (topic strings, fan-out to every subscriber,
QoS 0). Any process can host :class:`PubSubBroker`; the others dial it with
:class:`BrokerClient`. :class:`NativePubSubBroker` runs the same protocol
in the port's C++ epoll broker (``ops/csrc/broker.cpp``, built with the
host compiler at first use) as a child process. The body is opaque bytes
to either broker. A :class:`BrokerClient` that publishes under an open span
puts the reference's trace envelope (``telemetry.wrap_frame_body``) in
front of the body, and its reader strips an envelope and runs the handler
under the context it carried, so publisher and subscriber spans stitch
into one trace, between the two packages too; a publish without an open
span, or with ``propagate_trace=False``, is byte-unchanged.
"""
from __future__ import annotations

import logging
import socket
import struct
import subprocess
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from fedml_tpu_torch.telemetry.registry import get_registry
from fedml_tpu_torch.telemetry.spans import (
    activate_context,
    current_context,
    deactivate_context,
    unwrap_frame_body,
    wrap_frame_body,
)

logger = logging.getLogger(__name__)

_OP_SUB = b"S"
_OP_PUB = b"P"
MAX_FRAME = 1 << 30
# a lost connection is re-dialled this many times, backing off up to this
_RECONNECT_ATTEMPTS = 30
_RECONNECT_MAX_DELAY_S = 2.0


def _send_frame(sock: socket.socket, payload: bytes) -> None:
    sock.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_frame(sock: socket.socket) -> Optional[bytes]:
    head = _recv_exact(sock, 4)
    if head is None:
        return None
    (n,) = struct.unpack(">I", head)
    if n > MAX_FRAME:
        raise ValueError(f"frame of {n} bytes exceeds limit")
    return _recv_exact(sock, n)


def _hard_close(sock: socket.socket) -> None:
    """shutdown + close: a bare close() while another thread is blocked in
    recv() on the socket can defer the FIN on some kernels; shutdown wakes
    both sides."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:  # pragma: no cover
        pass


def _pack(op: bytes, topic: str, body: bytes = b"") -> bytes:
    t = topic.encode()
    return op + struct.pack(">H", len(t)) + t + body


def _unpack(payload: bytes) -> Tuple[bytes, str, bytes]:
    op = payload[:1]
    (tlen,) = struct.unpack(">H", payload[1:3])
    return op, payload[3:3 + tlen].decode(), payload[3 + tlen:]


class PubSubBroker:
    """The broker: accepts connections and routes publishes."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self._srv = socket.create_server((host, port))
        # a finite accept timeout keeps the loop interruptible (closing a
        # listener does not unblock accept() on every kernel)
        self._srv.settimeout(0.5)
        self._subs: Dict[str, List[socket.socket]] = {}
        self._lock = threading.Lock()
        reg = get_registry()
        self._m_bytes_in = reg.counter("broker/bytes_in")
        self._m_bytes_out = reg.counter("broker/bytes_out")
        self._m_publish = reg.counter("broker/publish_frames")
        self._m_fanout = reg.counter("broker/fanout_deliveries")
        self._m_dropped = reg.counter("broker/dropped_deliveries")
        self._m_subscribers = reg.gauge("broker/subscriptions")
        self._m_publish_ms = reg.histogram("broker/publish_ms")
        # one write lock per subscriber socket: publishers fan out from their
        # own serve threads, and interleaved sendall calls would corrupt the
        # length-prefixed stream
        self._wlocks: Dict[socket.socket, threading.Lock] = {}
        self._stopping = threading.Event()
        self._threads: List[threading.Thread] = []

    @property
    def address(self) -> Tuple[str, int]:
        return self._srv.getsockname()[:2]

    def start(self) -> "PubSubBroker":
        t = threading.Thread(target=self._accept_loop, name="broker-accept", daemon=True)
        t.start()
        self._threads.append(t)
        return self

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._srv.accept()
            except TimeoutError:
                continue
            except OSError:
                return
            conn.settimeout(None)
            t = threading.Thread(target=self._serve, args=(conn,), daemon=True)
            t.start()
            self._threads.append(t)

    def _serve(self, conn: socket.socket) -> None:
        try:
            while not self._stopping.is_set():
                payload = _recv_frame(conn)
                if payload is None:
                    break
                self._m_bytes_in.inc(len(payload) + 4)
                op, topic, body = _unpack(payload)
                if op == _OP_SUB:
                    with self._lock:
                        self._subs.setdefault(topic, []).append(conn)
                        self._wlocks.setdefault(conn, threading.Lock())
                        self._m_subscribers.set(sum(len(s) for s in self._subs.values()))
                elif op == _OP_PUB:
                    self._route(topic, body)
        except (ConnectionError, ValueError, OSError):
            pass
        finally:
            with self._lock:
                for subs in self._subs.values():
                    if conn in subs:
                        subs.remove(conn)
                self._wlocks.pop(conn, None)
                self._m_subscribers.set(sum(len(s) for s in self._subs.values()))
            _hard_close(conn)

    def _route(self, topic: str, body: bytes) -> None:
        with self._lock:
            targets = [(sock, self._wlocks.setdefault(sock, threading.Lock()))
                       for sock in self._subs.get(topic, [])]
        frame = _pack(_OP_PUB, topic, body)
        self._m_publish.inc()
        t0 = time.time()
        for sock, wlock in targets:
            try:
                with wlock:
                    _send_frame(sock, frame)
                self._m_bytes_out.inc(len(frame) + 4)
                self._m_fanout.inc()
            except OSError:
                self._m_dropped.inc()  # the subscriber died; pruned on exit
        self._m_publish_ms.observe((time.time() - t0) * 1e3)

    def stop(self) -> None:
        self._stopping.set()
        try:  # wake a parked accept() so the close releases the port
            socket.create_connection(self.address, timeout=1).close()
        except OSError:  # pragma: no cover
            pass
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = set(self._wlocks)
            for subs in self._subs.values():
                conns.update(subs)
        for conn in conns:
            _hard_close(conn)


class NativePubSubBroker:
    """The C++ epoll broker behind :class:`PubSubBroker`'s surface
    (``address``, ``start``, ``stop``): the counterpart of the JAX package's
    ``NativePubSubBroker``, on the port's own copy of the source, built into
    ``build/fedml_tpu_torch/`` (never into ``native/``). The constructor
    spawns the binary and reads its ``LISTENING <port>`` line; ``stop``
    terminates and reaps it."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        from fedml_tpu_torch.ops._build import build_executable

        self._proc = subprocess.Popen([str(build_executable("broker")), str(port), host],
                                      stdout=subprocess.PIPE, text=True)
        line = (self._proc.stdout.readline() or "").strip()
        if not line.startswith("LISTENING "):
            self._proc.kill()
            self._proc.wait()
            raise RuntimeError(f"native broker failed to start: {line!r}")
        self._addr = (host, int(line.split()[1]))

    @property
    def address(self) -> Tuple[str, int]:
        return self._addr

    def start(self) -> "NativePubSubBroker":
        return self  # the process is already serving

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait()  # reap: no zombie outlives the broker
        self._proc.stdout.close()


class BrokerClient:
    """A connection: ``subscribe(topic, handler)`` and ``publish(topic,
    body)``; handlers run on the client's reader thread.

    A lost connection is re-dialled with the seeded backoff, every topic is
    resubscribed, and ``publish`` waits (bounded) for the new socket, as
    the reference's federation transport does; resent frames are dropped by
    the comm manager's message ids, not here.
    """

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 propagate_trace: bool = True):
        self._propagate = bool(propagate_trace)
        self._addr = (host, port)
        self._timeout = float(timeout)
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._sock.settimeout(None)
        self._handlers: Dict[str, Callable[[bytes], None]] = {}
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._connected = threading.Event()
        self._connected.set()
        reg = get_registry()
        self._m_pub_bytes = reg.counter("broker/client_bytes_out")
        self._m_recv_bytes = reg.counter("broker/client_bytes_in")
        self._m_disconnects = reg.counter("resilience/broker_disconnects")
        self._m_reconnects = reg.counter("resilience/broker_reconnects")
        self._reader = threading.Thread(target=self._read_loop, name="broker-reader",
                                        daemon=True)
        self._reader.start()

    def subscribe(self, topic: str, handler: Callable[[bytes], None]) -> None:
        with self._lock:
            self._handlers[topic] = handler
            _send_frame(self._sock, _pack(_OP_SUB, topic))

    def publish(self, topic: str, body: bytes) -> None:
        if self._propagate and current_context() is not None:
            body = wrap_frame_body(body)
        self._m_pub_bytes.inc(len(body))
        # one bounded resend after the reader restores the socket
        for attempt in (0, 1):
            if not self._connected.wait(timeout=self._timeout):
                raise ConnectionError(
                    f"broker {self._addr} not reconnected within {self._timeout}s")
            try:
                with self._lock:
                    sock = self._sock
                    _send_frame(sock, _pack(_OP_PUB, topic, body))
                return
            except OSError:
                if attempt or self._stopping.is_set():
                    raise
                # gate on the reader's reconnect only if the failed socket is
                # still current (it may already have swapped in a new one)
                with self._lock:
                    if sock is self._sock:
                        self._connected.clear()

    def _on_connection_lost(self) -> None:
        self._connected.clear()
        _hard_close(self._sock)
        self._m_disconnects.inc()
        logger.warning("broker connection %s lost - reconnecting", self._addr)

    def _try_reconnect(self) -> bool:
        from fedml_tpu_torch.resilience.policy import RetryPolicy

        delays = RetryPolicy(max_attempts=_RECONNECT_ATTEMPTS + 1, base_delay_s=0.05,
                             max_delay_s=_RECONNECT_MAX_DELAY_S,
                             key=f"broker:{self._addr}").delays()
        for delay in delays:
            if self._stopping.is_set():
                return False
            time.sleep(delay)
            try:
                sock = socket.create_connection(self._addr, timeout=self._timeout)
                sock.settimeout(None)
            except OSError:
                continue
            with self._lock:
                try:
                    # a restarted broker has no subscriptions: replay every
                    # topic before the socket becomes current
                    for topic in self._handlers:
                        _send_frame(sock, _pack(_OP_SUB, topic))
                except OSError:
                    _hard_close(sock)
                    continue
                self._sock = sock
            self._m_reconnects.inc()
            self._connected.set()
            logger.info("broker connection %s restored", self._addr)
            return True
        return False

    def _read_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                payload = _recv_frame(self._sock)
            except OSError:
                payload = None
            if payload is None:
                if self._stopping.is_set():
                    return
                self._on_connection_lost()
                if self._try_reconnect():
                    continue
                return
            _, topic, body = _unpack(payload)
            self._m_recv_bytes.inc(len(body))
            ctx, body = unwrap_frame_body(body)
            handler = self._handlers.get(topic)
            if handler is not None:
                token = activate_context(ctx)
                try:
                    handler(body)
                except Exception:
                    logger.exception("broker handler failed on %s", topic)
                finally:
                    deactivate_context(token)

    def close(self) -> None:
        self._stopping.set()
        self._connected.set()  # unblock publishers waiting on a reconnect
        _hard_close(self._sock)
