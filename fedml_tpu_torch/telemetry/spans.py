"""Hierarchical spans with cross-process trace propagation.

The port's twin of ``fedml_tpu/telemetry/spans.py``. Every span carries a
``(trace_id, span_id, parent_id)`` triple. Inside one process the current
span rides a ``contextvars.ContextVar``; across processes the context
travels as a header:

- comm messages (LOCAL, BROKER, GRPC, TRPC): a JSON-safe ``telemetry_ctx``
  field that ``FedMLCommManager.send_message`` puts into the message's
  params and the receiving rank re-activates around the handler;
- raw broker bodies: a binary envelope (magic, JSON header) that
  ``BrokerClient`` puts in front of a body published under an open span
  and strips on the subscriber's side.

Header and envelope are the reference's byte for byte, so spans stitch
across the two packages in a mixed federation. Span names follow the
taxonomy ``round/<n>[/client/<id>]/<phase>`` for round work and
``<subsystem>/<what>`` elsewhere.

Where the reference attributes XLA compile seconds to the open span, the
port attributes its first-use kernel builds (``ops/_build.py``: nvcc and
the host compiler) the same way: :func:`note_kernel_build` adds the
build's milliseconds to the open span's ``compile_ms``, the attribute
``telemetry report`` sums.

On the card a span's wall is host time: it closes when its work has been
enqueued, not when the card has finished it, unless the traced code
synchronises there anyway. Spans never synchronise.
"""
from __future__ import annotations

import atexit
import contextlib
import contextvars
import json
import os
import struct
import threading
import time
import uuid
import weakref
from typing import Any, Dict, Iterator, List, Optional

from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.registry import get_registry

CTX_KEY = "telemetry_ctx"
_FRAME_MAGIC = b"\xf5TCX"


class TraceContext:
    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id

    def to_dict(self) -> Dict[str, str]:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_dict(cls, d: Dict[str, str]) -> "TraceContext":
        return cls(str(d["trace_id"]), str(d["span_id"]))

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id}/{self.span_id})"


_current: "contextvars.ContextVar[Optional[_ActiveSpan]]" = contextvars.ContextVar(
    "fedml_telemetry_span", default=None)


class _ActiveSpan:
    """A span in flight; :meth:`Tracer.end` turns it into a record."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "started",
                 "started_mono", "attrs", "remote_parent", "placeholder",
                 "compile_ms")

    def __init__(self, name: str, trace_id: str, parent_id: Optional[str],
                 remote_parent: bool, attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = uuid.uuid4().hex[:16]
        self.parent_id = parent_id
        # the wall clock places the span; the monotonic clock measures it, so
        # a clock step mid-span cannot corrupt its length
        self.started = time.time()
        self.started_mono = time.perf_counter()
        self.attrs = attrs
        self.remote_parent = remote_parent
        self.placeholder = False
        self.compile_ms = 0.0

    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)


def new_trace_id() -> str:
    return uuid.uuid4().hex


def current_context() -> Optional[TraceContext]:
    span = _current.get()
    return span.context() if span is not None else None


def activate_context(ctx: Optional[TraceContext]):
    """Adopt a remote context as the current parent; returns a reset token.
    The context is held by a placeholder that records nothing, so child
    spans stitch to the remote span id."""
    if ctx is None:
        return None
    holder = _ActiveSpan("remote", ctx.trace_id, None, True, {})
    holder.span_id = ctx.span_id
    holder.placeholder = True
    return _current.set(holder)


def deactivate_context(token) -> None:
    if token is not None:
        _current.reset(token)


# -- header propagation (a comm message's params) ---------------------------
def inject_context(params: Dict[str, Any]) -> None:
    ctx = current_context()
    if ctx is not None:
        params[CTX_KEY] = ctx.to_dict()


def extract_context(params: Dict[str, Any]) -> Optional[TraceContext]:
    raw = params.pop(CTX_KEY, None)
    if not isinstance(raw, dict) or "trace_id" not in raw:
        return None
    try:
        return TraceContext.from_dict(raw)
    except (KeyError, TypeError):
        return None


# -- frame propagation (raw broker bodies) ----------------------------------
def wrap_frame_body(body: bytes, ctx: Optional[TraceContext] = None) -> bytes:
    """Prepend the trace header to a pub/sub body (the body unchanged
    without a context). Layout: magic ‖ u16 header_len ‖ json(ctx) ‖ body;
    brokers route bodies opaquely, so the envelope is invisible to them."""
    ctx = ctx or current_context()
    if ctx is None:
        return body
    header = json.dumps(ctx.to_dict()).encode()
    return _FRAME_MAGIC + struct.pack(">H", len(header)) + header + body


def unwrap_frame_body(body: bytes):
    """``(ctx or None, original body)``; a body without the envelope, or
    one that only starts with the magic by accident, passes through."""
    if not body.startswith(_FRAME_MAGIC) or len(body) < 6:
        return None, body
    (hlen,) = struct.unpack(">H", body[4:6])
    if len(body) < 6 + hlen:
        return None, body
    try:
        ctx = TraceContext.from_dict(json.loads(body[6:6 + hlen]))
    except (ValueError, KeyError, TypeError, UnicodeDecodeError):
        return None, body
    return ctx, body[6 + hlen:]


# -- kernel-build attribution -------------------------------------------------
def note_kernel_build(what: str, ms: float) -> None:
    """Attribute one first-use build (``ops/_build.py``) to the open span's
    ``compile_ms`` and to the ``build/compile_ms`` histogram."""
    get_registry().histogram("build/compile_ms").observe(ms)
    span = _current.get()
    if span is not None:
        span.compile_ms += ms
    flight_recorder.record("kernel_build", what=what, ms=round(float(ms), 3))


# one exit hook over weak references: tracers stay collectable, and the exit
# flush covers however many are still alive
_live_tracers: "weakref.WeakSet[Tracer]" = weakref.WeakSet()


def _flush_live_tracers() -> None:
    for t in list(_live_tracers):
        if t.sink_dir is not None and flight_recorder.removed_since_seen(t.sink_dir):
            continue  # its run dir was removed: leave it removed
        try:
            t.flush()
        except OSError:
            pass


atexit.register(_flush_live_tracers)


# -- span listeners -----------------------------------------------------------
# process-wide observers of every completed span and point event; a listener
# that raises is ignored (observability never breaks the traced code)
_span_listeners: List[Any] = []
_span_listeners_lock = threading.Lock()


def add_span_listener(fn) -> None:
    """Register ``fn(record)`` for every span and event any tracer of this
    process records."""
    with _span_listeners_lock:
        if fn not in _span_listeners:
            _span_listeners.append(fn)


def remove_span_listener(fn) -> None:
    with _span_listeners_lock:
        try:
            _span_listeners.remove(fn)
        except ValueError:
            pass


def _notify_span_listeners(rec: Dict) -> None:
    with _span_listeners_lock:
        listeners = list(_span_listeners)
    for fn in listeners:
        try:
            fn(rec)
        except Exception:  # noqa: BLE001 - listeners never raise out
            pass


class Tracer:
    """Span factory and buffered JSONL sink.

    Completed spans buffer in memory and go to ``<sink_dir>/<filename>``
    when the buffer reaches ``buffer_limit``, on :meth:`flush` and at exit;
    each flush is one ``write`` of whole lines, so processes sharing a run
    dir never interleave inside a line.
    """

    def __init__(self, sink_dir: Optional[str] = None,
                 filename: str = "spans.jsonl", buffer_limit: int = 256,
                 service: str = ""):
        self._dir = sink_dir
        self._filename = filename
        self._limit = max(int(buffer_limit), 1)
        self.service = service
        self._lock = threading.Lock()
        self._records: List[Dict] = []
        _live_tracers.add(self)

    @property
    def sink_dir(self) -> Optional[str]:
        return self._dir

    # -- span lifecycle ---------------------------------------------------
    def begin(self, name: str, **attrs: Any) -> _ActiveSpan:
        parent = _current.get()
        if parent is not None:
            # only the direct child of an adopted remote context is marked
            # stitched; its descendants are ordinary local spans
            return _ActiveSpan(name, parent.trace_id, parent.span_id,
                               parent.placeholder, attrs)
        return _ActiveSpan(name, new_trace_id(), None, False, attrs)

    def end(self, span: _ActiveSpan, ended: Optional[float] = None) -> Dict:
        if ended is None:
            # the length from the monotonic clock; `ended` derived from it so
            # that ended - started == duration for readers
            duration_ms = (time.perf_counter() - span.started_mono) * 1e3
            ended = span.started + duration_ms / 1e3
        else:
            # an explicit end time is wall clock by contract
            duration_ms = (ended - span.started) * 1e3
        rec = {
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "started": span.started,
            "mono": span.started_mono,
            "ended": ended,
            "duration_ms": duration_ms,
        }
        if span.compile_ms:
            rec["compile_ms"] = span.compile_ms
            rec["execute_ms"] = max(duration_ms - span.compile_ms, 0.0)
        if span.remote_parent:
            rec["remote_parent"] = True
        if self.service:
            rec["service"] = self.service
        if span.attrs:
            rec["attrs"] = span.attrs
        self._append(rec)
        # a condensed copy rides the flight recorder, so a crash dump shows
        # the last spans even when the sink buffer died with the process
        flight_recorder.on_span(rec)
        _notify_span_listeners(rec)
        return rec

    def event(self, name: str, **attrs: Any) -> Dict:
        """A zero-duration point record at this instant: ``point: true`` and
        no ``duration_ms``, so the report's span consumers skip it."""
        rec: Dict[str, Any] = {"name": name, "point": True, "ts": time.time(),
                               "mono": time.perf_counter()}
        ctx = current_context()
        if ctx is not None:
            rec["trace_id"] = ctx.trace_id
            rec["span_id"] = ctx.span_id
        if self.service:
            rec["service"] = self.service
        if attrs:
            rec["attrs"] = attrs
        self._append(rec)
        _notify_span_listeners(rec)
        return rec

    @contextlib.contextmanager
    def span(self, name: str, **attrs: Any) -> Iterator[_ActiveSpan]:
        s = self.begin(name, **attrs)
        token = _current.set(s)
        try:
            yield s
        finally:
            _current.reset(token)
            self.end(s)

    # -- sink -------------------------------------------------------------
    def _append(self, rec: Dict) -> None:
        overflow = None
        with self._lock:
            self._records.append(rec)
            if len(self._records) >= self._limit:
                overflow, self._records = self._records, []
        if overflow is not None:
            self._write(overflow)

    def records(self) -> List[Dict]:
        with self._lock:
            return list(self._records)

    def _write(self, records: List[Dict]) -> Optional[str]:
        if self._dir is None or not records:
            return None
        os.makedirs(self._dir, exist_ok=True)
        flight_recorder.note_dir(self._dir)
        path = os.path.join(self._dir, self._filename)
        text = "".join(json.dumps(rec, default=str) + "\n" for rec in records)
        with open(path, "a") as f:
            f.write(text)
        return path

    def flush(self) -> Optional[str]:
        with self._lock:
            records, self._records = self._records, []
        return self._write(records)


_default_tracer: Optional[Tracer] = None
_default_lock = threading.Lock()


def get_tracer() -> Tracer:
    """The process-global tracer (memory-only until :func:`configure` points
    it at a run dir)."""
    global _default_tracer
    with _default_lock:
        if _default_tracer is None:
            _default_tracer = Tracer()
        return _default_tracer


def configure(run_dir: str, service: str = "") -> Tracer:
    """Bind the global tracer to a run dir (kept while the dir stays the
    same) and point the flight recorder's dumps there."""
    global _default_tracer
    with _default_lock:
        t = _default_tracer
        if t is None or t._dir != run_dir:
            t = Tracer(sink_dir=run_dir, service=service)
            _default_tracer = t
    flight_recorder.bind(run_dir)
    return t


def configure_from_args(args: Any, service: str = "") -> Tracer:
    """The global tracer for a run: sink dir ``<log_file_dir>/run_<run_id>/``
    (the layout core/mlops uses too) and ``service`` stamped on every record
    (what tells the processes of a shared run dir apart). The reference's deep-trace knobs (``trace_rounds``)
    come with ROADMAP A12b."""
    run_id = str(getattr(args, "run_id", "0") or "0")
    base = str(getattr(args, "log_file_dir", "") or ".fedml_logs")
    return configure(os.path.join(base, f"run_{run_id}"), service=service)


def flush_run() -> Optional[str]:
    """Land the global tracer's spans and a registry snapshot in the run
    dir (nothing for a memory-only tracer): the one call a
    training loop makes at the end of ``train()``."""
    tracer = get_tracer()
    tracer.flush()
    if tracer.sink_dir is None:
        return None
    return get_registry().flush_jsonl(tracer.sink_dir)


def reset_tracer() -> None:
    """Drop the global tracer (test isolation)."""
    global _default_tracer
    with _default_lock:
        _default_tracer = None
