"""Live span-batch streaming: bounded frames over the live plane (the port's
copy of ``fedml_tpu/telemetry/tracing/stream.py``; its frames are the
reference's, so either package's collector merges the other's).

``SpanStreamer`` taps the process-global span listeners
(:func:`fedml_tpu_torch.telemetry.spans.add_span_listener`) and buffers every
completed span / point event in a bounded ring, each entry carrying an
absolute, per-node, monotonically increasing index. Frames ship either
piggybacked on outgoing comm messages (the cross-silo client path — same
split as ``MetricStreamer``) or via a dedicated ``send_cb`` carrier (the
serving endpoint path):

- a *delta* frame carries the unsent contiguous index range (capped per
  frame);
- every ``resync_every``-th frame — and the final flush — is a *FULL*
  frame carrying the whole ring, so dropped frames heal without acks.

``TraceCollector`` merges frames idempotently **by absolute index**:
duplicates overwrite themselves, reordering is irrelevant, and drops are
healed by the next full frame — chaos-grade delivery converges to the
identical record set (and therefore the identical critical path) as
loss-free delivery. Only records evicted from the ring before ever being
shipped are truly lost, and those are counted (``tracepath/
records_dropped``).
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

FRAME_KIND = "trace"
FRAME_VERSION = 1

# phase -> integer code for the registry (gauges are numeric-only); the
# watch column and doctor decode through phase_label().
PHASE_CODES: Dict[str, int] = {
    "sync": 0, "train": 1, "aggregate": 2, "eval": 3, "wire": 4,
    "dispatch": 5, "gap": 6, "sample": 7, "stage": 8, "other": 9,
}
_PHASE_LABELS = {v: k for k, v in PHASE_CODES.items()}


def phase_code(phase: Optional[str]) -> int:
    return PHASE_CODES.get(phase or "other", PHASE_CODES["other"])


def phase_label(code: float) -> str:
    return _PHASE_LABELS.get(int(code), "other")


def frame_nbytes(frame: Dict[str, Any]) -> int:
    try:
        return len(json.dumps(frame, default=str))
    except (TypeError, ValueError):
        return 0


class SpanStreamer:
    """Span-record ring with seq-numbered, drop-tolerant frame emission."""

    def __init__(self, node: str, job: str = "", interval_s: float = 1.0,
                 ring: int = 4096, max_batch: int = 256,
                 resync_every: int = 8,
                 send_cb: Optional[Callable[[Dict[str, Any]], None]] = None,
                 registry: Any = None):
        self.node = node
        self.job = job
        self.interval_s = max(float(interval_s), 0.05)
        self._ring_cap = max(int(ring), 8)
        self._max_batch = max(int(max_batch), 1)
        self._resync_every = max(int(resync_every), 2)
        self._send_cb = send_cb
        self._lock = threading.Lock()
        self._ring: "deque[tuple]" = deque()  # (abs_idx, record)
        self._next_idx = 0
        self._sent_upto = 0  # first index not yet emitted in any frame
        self._seq = 0
        self._last_emit = 0.0
        self._force_full = False
        self._attached = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if registry is None:
            from fedml_tpu_torch.telemetry.registry import get_registry

            registry = get_registry()
        self._c_frames = registry.counter("tracepath/frames_emitted")
        self._c_bytes = registry.counter("tracepath/frame_bytes")
        self._c_shipped = registry.counter("tracepath/records_shipped")
        self._c_dropped = registry.counter("tracepath/records_dropped")

    # -- record intake -----------------------------------------------------
    def on_record(self, rec: Dict[str, Any]) -> None:
        """Span-listener callback; must never raise (and the listener
        dispatch swallows anyway)."""
        with self._lock:
            self._ring.append((self._next_idx, dict(rec)))
            self._next_idx += 1
            while len(self._ring) > self._ring_cap:
                idx, _ = self._ring.popleft()
                if idx >= self._sent_upto:
                    # evicted before any frame carried it: unrecoverable
                    self._c_dropped.inc()
                    self._sent_upto = idx + 1

    def attach(self) -> "SpanStreamer":
        """Register on the process span listeners (idempotent)."""
        if not self._attached:
            from fedml_tpu_torch.telemetry import spans as _spans

            _spans.add_span_listener(self.on_record)
            self._attached = True
        return self

    def detach(self) -> None:
        if self._attached:
            from fedml_tpu_torch.telemetry import spans as _spans

            _spans.remove_span_listener(self.on_record)
            self._attached = False

    # -- frame emission ----------------------------------------------------
    def _due_full(self) -> bool:
        return self._force_full or (self._seq + 1) % self._resync_every == 0

    def pop_frame(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """The next frame, or None when rate-limited / nothing new.

        Callers on the piggyback path call this per outgoing message; the
        interval gate keeps one frame per ``interval_s`` regardless of
        message rate.
        """
        now = time.monotonic()
        with self._lock:
            if not force and now - self._last_emit < self.interval_s:
                return None
            full = self._due_full()
            if full:
                batch = list(self._ring)
            else:
                batch = [(i, r) for i, r in self._ring
                         if i >= self._sent_upto][: self._max_batch]
            if not batch:
                return None
            base = batch[0][0]
            self._sent_upto = max(self._sent_upto, base + len(batch))
            self._seq += 1
            seq = self._seq
            self._force_full = False
            self._last_emit = now
        frame = {
            "kind": FRAME_KIND, "v": FRAME_VERSION, "node": self.node,
            "job": self.job, "seq": seq, "base": base, "full": full,
            "records": [r for _, r in batch],
        }
        self._c_frames.inc()
        self._c_bytes.inc(frame_nbytes(frame))
        self._c_shipped.inc(len(batch))
        return frame

    def pump(self, collector: "TraceCollector", force: bool = True) -> bool:
        """Synchronous snapshot->frame->ingest (loopback and tests)."""
        frame = self.pop_frame(force=force)
        if frame is None:
            return False
        return collector.ingest(frame)

    def flush_final(self) -> None:
        """Arm a FULL frame so the next pop re-ships the whole ring —
        called right before the last messages of a run go out."""
        with self._lock:
            self._force_full = True
            self._last_emit = 0.0

    # -- dedicated carrier -------------------------------------------------
    def start(self) -> "SpanStreamer":
        self.attach()
        if self._send_cb is not None and self._thread is None:
            self._thread = threading.Thread(target=self._loop,
                                            name=f"span-streamer-{self.node}",
                                            daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            frame = self.pop_frame(force=True)
            if frame is not None:
                try:
                    self._send_cb(frame)
                except Exception:  # noqa: BLE001 - carrier must not die
                    pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None
        self.detach()

    def close(self) -> Optional[Dict[str, Any]]:
        """Stop the loop and emit one final FULL frame (delivered through
        ``send_cb`` when set; also returned for loopback ingestion)."""
        self.stop()
        with self._lock:
            self._force_full = True
            self._last_emit = 0.0
        frame = self.pop_frame(force=True)
        if frame is not None and self._send_cb is not None:
            try:
                self._send_cb(frame)
            except Exception:  # noqa: BLE001
                pass
        return frame


class TraceCollector:
    """Merges span-batch frames from every node, idempotently by index."""

    def __init__(self, job: str = "", registry: Any = None):
        self.job = job
        self._lock = threading.Lock()
        # node -> {"records": {abs_idx: rec}, "last_seq": int}
        self._nodes: Dict[str, Dict[str, Any]] = {}
        if registry is None:
            from fedml_tpu_torch.telemetry.registry import get_registry

            registry = get_registry()
        self._c_ingested = registry.counter("tracepath/frames_ingested")
        self._c_dup = registry.counter("tracepath/frames_duplicate")
        self._c_gaps = registry.counter("tracepath/seq_gaps")
        self._c_merged = registry.counter("tracepath/records_merged")

    def ingest(self, frame: Any) -> bool:
        if not isinstance(frame, dict) or frame.get("kind") != FRAME_KIND:
            return False
        if int(frame.get("v", -1)) != FRAME_VERSION:
            return False
        node = frame.get("node")
        records = frame.get("records")
        if not node or not isinstance(records, list):
            return False
        if self.job and frame.get("job") and frame["job"] != self.job:
            return False  # a stale run's frames must not pollute this one
        try:
            seq = int(frame.get("seq", 0))
            base = int(frame.get("base", 0))
        except (TypeError, ValueError):
            return False
        merged = 0
        with self._lock:
            st = self._nodes.setdefault(str(node),
                                        {"records": {}, "last_seq": 0})
            if seq <= st["last_seq"]:
                # duplicate / reordered frame: counted, but still merged —
                # the index keys make re-application a no-op
                self._c_dup.inc()
            elif seq > st["last_seq"] + 1:
                self._c_gaps.inc(seq - st["last_seq"] - 1)
            st["last_seq"] = max(st["last_seq"], seq)
            store = st["records"]
            for i, rec in enumerate(records):
                if not isinstance(rec, dict):
                    continue
                idx = base + i
                if idx not in store:
                    store[idx] = rec
                    merged += 1
        self._c_ingested.inc()
        if merged:
            self._c_merged.inc(merged)
        return True

    def records(self) -> List[Dict[str, Any]]:
        """Every merged record, node-stamped, in per-node index order."""
        out: List[Dict[str, Any]] = []
        with self._lock:
            for node in sorted(self._nodes):
                store = self._nodes[node]["records"]
                for idx in sorted(store):
                    rec = dict(store[idx])
                    rec.setdefault("node", node)
                    out.append(rec)
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {node: {"records": len(st["records"]),
                           "last_seq": st["last_seq"]}
                    for node, st in self._nodes.items()}

    def persist(self, run_dir: str,
                filename: Optional[str] = None) -> Optional[str]:
        """Land the merged set as a node-annotated JSONL next to the local
        sink (rewritten whole — the merge is the source of truth)."""
        import os

        from fedml_tpu_torch.telemetry.tracing.assemble import (
            REMOTE_SPANS_FILENAME,
        )

        records = self.records()
        if not records:
            return None
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, filename or REMOTE_SPANS_FILENAME)
        with open(path, "w") as f:
            for rec in records:
                f.write(json.dumps(rec, default=str) + "\n")
        return path
