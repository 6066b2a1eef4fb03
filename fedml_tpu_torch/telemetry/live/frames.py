"""Metric frames — the unit of live telemetry streaming (the port's copy of
``fedml_tpu/telemetry/live/frames.py``; the frames are the reference's, field
for field).

A **frame** is a seq-numbered, node-/job-stamped batch of metric readings
a node ships to the collector while the run is in flight. Readings are
CUMULATIVE (a counter's total, a gauge's value, a histogram's full bucket
counts), *delta-filtered*: a frame only carries the instruments that
changed since the last frame this streamer emitted. Cumulative-but-
delta-filtered is the load-bearing choice:

- **duplicate frames are idempotent** — the collector diffs each reading
  against the last value it applied for that (node, metric), so replaying
  a frame applies a zero delta;
- **dropped frames self-heal** — the next frame that carries the metric
  re-ships its full cumulative value, and every ``resync_every``-th frame
  (plus the final frame at :meth:`MetricStreamer.close`) is a FULL
  snapshot, so the collector converges to exact totals even over a lossy
  path (the seq gap is still *accounted*: ``live/seq_gaps``);
- **bounded bytes** — steady state ships only what moved, capped at
  ``max_entries`` per frame with carry-over rotation, so a node's wire
  cost per round is bounded no matter how many instruments exist.

The streamer snapshots its registry OFF-THREAD (a daemon thread prepares
the next frame every ``interval_s``); the hot send path only pops the
prepared frame — no device sync, no JSON work on the sending thread
beyond what the transport does anyway. Frames piggyback on existing
federation traffic via ``FedMLCommManager`` (see
``Message.MSG_ARG_KEY_TELEMETRY``) where traffic exists; where it does
not, pass ``send_cb`` and the off-thread loop emits a low-frequency
dedicated frame itself.
"""
from __future__ import annotations

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from fedml_tpu_torch.telemetry.registry import (
    BYTES_BUCKETS,
    MetricsRegistry,
    get_registry,
)

__all__ = ["FRAME_VERSION", "MetricStreamer", "frame_nbytes"]

FRAME_VERSION = 1

# collector-plane meta-metrics never ride frames: the collector's own
# live/* instruments would otherwise chase their tails (each ingest
# changes them, making every frame "changed"), and equality between the
# collector's merged totals and the node's post-hoc snapshot would be
# unprovable
DEFAULT_EXCLUDE_PREFIXES: Tuple[str, ...] = ("live/",)


def frame_nbytes(frame: Dict[str, Any]) -> int:
    """Wire-cost estimate of a frame (its JSON length)."""
    return len(json.dumps(frame))


def _entry_of(rec: Dict[str, Any]) -> Dict[str, Any]:
    """One frame entry from a registry snapshot record (cumulative)."""
    entry: Dict[str, Any] = {
        "name": rec["name"],
        "kind": rec["kind"],
    }
    if rec.get("labels"):
        entry["labels"] = dict(rec["labels"])
    if rec["kind"] == "histogram":
        entry["count"] = rec["count"]
        entry["sum"] = rec["sum"]
        entry["min"] = rec["min"]
        entry["max"] = rec["max"]
        entry["buckets"] = dict(rec["buckets"])
    else:
        entry["value"] = rec["value"]
    return entry


def _changed(entry: Dict, prev: Optional[Dict]) -> bool:
    if prev is None:
        return True
    if entry["kind"] == "histogram":
        return (entry["count"] != prev["count"]
                or entry["sum"] != prev["sum"])
    return entry["value"] != prev["value"]


class MetricStreamer:
    """Periodic off-thread snapshotter of one registry into metric frames.

    ``node`` is this stream's identity at the collector (one streamer per
    process in a real deployment — the process-global registry IS the
    node's registry); ``job`` namespaces multi-tenant collectors.

    Usage::

        streamer = MetricStreamer("rank1", job=run_id).start()
        # hot path (FedMLCommManager.send_message does this):
        frame = streamer.pop_frame()     # None unless one is due
        # loopback (server-side own metrics):
        streamer.pump(collector, force=True)
        final = streamer.close()         # full snapshot, stream end
    """

    def __init__(self, node: str, job: str = "default",
                 registry: Optional[MetricsRegistry] = None,
                 interval_s: float = 1.0,
                 max_entries: int = 256,
                 resync_every: int = 8,
                 exclude_prefixes: Tuple[str, ...] = DEFAULT_EXCLUDE_PREFIXES,
                 send_cb: Optional[Callable[[Dict], None]] = None):
        self.node = str(node)
        self.job = str(job)
        self._registry = registry
        self.interval_s = float(interval_s)
        self.max_entries = max(1, int(max_entries))
        self.resync_every = max(1, int(resync_every))
        self.exclude_prefixes = tuple(exclude_prefixes)
        self._send_cb = send_cb
        self._lock = threading.Lock()
        self._seq = 0
        self._last_sent: Dict[Tuple, Dict] = {}
        self._carry: List[Tuple] = []  # changed keys deferred by the cap
        self._prepared: Optional[List[Dict]] = None
        self._prepared_full = False
        self._last_emit = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # frame cost instruments land in the PROCESS registry (they are
        # live/*, so they never ride frames themselves)
        reg = get_registry()
        self._m_frames = reg.counter("live/frames_emitted")
        self._h_bytes = reg.histogram("live/frame_bytes",
                                      buckets=BYTES_BUCKETS)

    # -- snapshot + delta filter ------------------------------------------
    def _source(self) -> MetricsRegistry:
        return self._registry if self._registry is not None else get_registry()

    def _scan(self) -> Dict[Tuple, Dict]:
        out: Dict[Tuple, Dict] = {}
        for rec in self._source().snapshot():
            name = rec["name"]
            if name.startswith(self.exclude_prefixes):
                continue
            key = (name, tuple(sorted((rec.get("labels") or {}).items())))
            out[key] = _entry_of(rec)
        return out

    def _build_entries(self, full: bool) -> Optional[List[Dict]]:
        """Entries for the next frame (None = nothing changed)."""
        scan = self._scan()
        with self._lock:
            if full:
                keys = sorted(scan)
            else:
                carried = [k for k in self._carry if k in scan]
                fresh = sorted(
                    k for k, e in scan.items()
                    if k not in carried and _changed(e, self._last_sent.get(k)))
                keys = carried + fresh
                if not keys:
                    return None
                self._carry = keys[self.max_entries:]
                keys = keys[: self.max_entries]
            return [scan[k] for k in keys]

    def _commit(self, entries: List[Dict], full: bool) -> Dict[str, Any]:
        """Stamp seq + node identity and mark the entries as sent."""
        with self._lock:
            self._seq += 1
            frame = {
                "v": FRAME_VERSION,
                "node": self.node,
                "job": self.job,
                "seq": self._seq,
                "ts": time.time(),
                "full": bool(full),
                "metrics": entries,
            }
            for e in entries:
                key = (e["name"],
                       tuple(sorted((e.get("labels") or {}).items())))
                self._last_sent[key] = e
            self._last_emit = time.time()
        self._m_frames.inc()
        self._h_bytes.observe(frame_nbytes(frame))
        return frame

    def _due_full(self) -> bool:
        return (self._seq + 1) % self.resync_every == 0

    # -- off-thread preparation -------------------------------------------
    def start(self) -> "MetricStreamer":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name=f"metric-streamer-{self.node}",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                entries = self._build_entries(full=self._due_full())
                if entries is None:
                    continue
                if self._send_cb is not None:
                    # dedicated low-frequency frame: no round traffic to
                    # ride, so this thread delivers it itself
                    self._send_cb(self._commit(entries, self._due_full()))
                else:
                    with self._lock:
                        # never displace a prepared FULL frame (a
                        # flush_final waiting for the last message out)
                        # with a delta — the stream's final frame must
                        # stay full or lost-frame healing is forfeited;
                        # entries are only marked sent at commit, so
                        # anything this delta carried is re-collected
                        if not (self._prepared is not None
                                and self._prepared_full):
                            self._prepared = entries
                            self._prepared_full = self._due_full()
            except Exception:  # pragma: no cover - observability never kills
                import logging

                logging.getLogger(__name__).exception(
                    "metric streamer scan failed")

    # -- hot-path surface --------------------------------------------------
    def pop_frame(self, force: bool = False) -> Optional[Dict[str, Any]]:
        """The prepared frame, seq-stamped — or None when nothing is due.

        Rate-limited to one frame per ``interval_s`` so a chatty transport
        cannot amplify telemetry traffic; ``force`` builds inline (the
        loopback pump and the final flush use it).
        """
        with self._lock:
            due = force or (time.time() - self._last_emit >= self.interval_s)
            if not due:
                # leave the prepared frame in place — discarding it here
                # would push the registry scan onto the next due send
                return None
            prepared, full = self._prepared, self._prepared_full
            self._prepared = None
        if force:
            # a forced pop (per-round pump, final flush) must reflect the
            # registry NOW, not a snapshot the prep thread took earlier;
            # discarding the prepared entries is safe — they are only
            # marked sent at commit, so they stay "changed" and are
            # re-collected by this fresh build
            prepared = None
        if prepared is None:
            # no prepared frame (prep thread hasn't fired since the last
            # emit) — build inline; rate-limited above, host-only work
            full = self._due_full()
            prepared = self._build_entries(full=full)
            if prepared is None:
                return None
        return self._commit(prepared, full)

    def pump(self, collector, force: bool = True) -> bool:
        """Loopback: build a frame and ingest it into ``collector``."""
        frame = self.pop_frame(force=force)
        if frame is None:
            return False
        collector.ingest(frame)
        return True

    def flush_final(self) -> None:
        """Prepare a FULL frame for the next ``pop_frame`` (stream close
        piggybacked on the last message out)."""
        entries = self._build_entries(full=True)
        with self._lock:
            self._prepared = entries or []
            self._prepared_full = True
            self._last_emit = 0.0  # make the next pop unconditionally due

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)

    def close(self) -> Optional[Dict[str, Any]]:
        """Stop the off-thread loop and return the final FULL frame (the
        collector's totals become exact the moment it lands)."""
        self.stop()
        entries = self._build_entries(full=True)
        if entries is None:
            entries = []
        frame = self._commit(entries, full=True)
        if self._send_cb is not None and frame["metrics"]:
            try:
                self._send_cb(frame)
            except Exception:  # pragma: no cover - transport already down
                pass
        return frame
