"""Live collector — merges metric frames into one labeled registry (the
port's copy of ``fedml_tpu/telemetry/live/collector.py``).

The collector is the receiving half of the live plane: every node's
frames (piggybacked on federation traffic, POSTed over HTTP, or pumped
in-process) merge into ONE aggregate :class:`MetricsRegistry` whose
instruments carry ``node`` and ``job`` labels on top of the original
metric labels. That registry is what the ``/metrics`` scrape endpoint
exposes and what the online doctor evaluates incrementally.

Merge contract (the chaos tests pin this down):

- frames apply **in seq order per node**; a frame whose seq is ≤ the
  last applied one is a duplicate/stale replay and is discarded whole
  (``live/duplicate_frames``) — entry values are cumulative, so even a
  partially-overlapping replay would apply zero deltas, but discarding
  at the seq gate keeps the account exact;
- a seq jump of k counts k-1 into ``live/seq_gaps`` — the *data* self-
  heals (cumulative entries + periodic full frames), the *account* of
  what the wire lost does not;
- counters merge by cumulative difference; a negative difference means
  the node restarted its process (registry reset) and the full new value
  re-applies (``live/counter_resets``);
- histograms merge by per-bucket count difference (bounds come with the
  frame), min/max as min/max;
- gauges are last-write-wins per node, like everywhere else.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from fedml_tpu_torch.telemetry.registry import MetricsRegistry, get_registry

__all__ = ["LiveCollector"]


class LiveCollector:
    """Thread-safe frame merger with per-node seq accounting."""

    def __init__(self, job: Optional[str] = None):
        self.job = job
        self.registry = MetricsRegistry()
        self._lock = threading.Lock()
        self._last_seq: Dict[str, int] = {}
        self._last_ts: Dict[str, float] = {}
        self._gaps: Dict[str, int] = {}
        self._applied: Dict[Tuple, Dict] = {}  # (node, key) -> last entry
        self._hooks: List[Callable[[Dict, "LiveCollector"], None]] = []
        self.started = time.time()
        reg = get_registry()
        self._m_ingested = reg.counter("live/frames_ingested")
        self._m_dup = reg.counter("live/duplicate_frames")
        self._m_gaps = reg.counter("live/seq_gaps")
        self._m_resets = reg.counter("live/counter_resets")
        self._m_bad = reg.counter("live/bad_frames")
        self._g_nodes = reg.gauge("live/nodes")

    def add_hook(self, fn: Callable[[Dict, "LiveCollector"], None]) -> None:
        """``fn(frame, collector)`` after every applied frame (the online
        doctor registers here). Hook failures never poison the merge."""
        self._hooks.append(fn)

    # -- merge -------------------------------------------------------------
    def ingest(self, frame: Any) -> bool:
        """Apply one frame; returns False for duplicates/garbage."""
        if not isinstance(frame, dict) or "node" not in frame \
                or "seq" not in frame or "metrics" not in frame:
            self._m_bad.inc()
            return False
        if self.job is not None and frame.get("job") not in (None, self.job):
            self._m_bad.inc()
            return False
        node = str(frame["node"])
        try:
            seq = int(frame["seq"])
        except (TypeError, ValueError):
            self._m_bad.inc()
            return False
        with self._lock:
            last = self._last_seq.get(node, 0)
            if seq <= last:
                self._m_dup.inc()
                return False
            if seq > last + 1:
                gap = seq - last - 1
                self._gaps[node] = self._gaps.get(node, 0) + gap
                self._m_gaps.inc(gap)
            self._last_seq[node] = seq
            self._last_ts[node] = float(frame.get("ts") or time.time())
            for entry in frame["metrics"]:
                try:
                    self._apply_locked(node, frame.get("job"), entry)
                except (KeyError, TypeError, ValueError):
                    self._m_bad.inc()
            self._g_nodes.set(len(self._last_seq))
        self._m_ingested.inc()
        for fn in self._hooks:
            try:
                fn(frame, self)
            except Exception:  # pragma: no cover - hook must not poison merge
                import logging

                logging.getLogger(__name__).exception(
                    "live collector hook failed")
        return True

    def _labels_for(self, node: str, job, entry: Dict) -> Dict[str, str]:
        labels = dict(entry.get("labels") or {})
        labels["node"] = node
        labels["job"] = str(job if job is not None else (self.job or "default"))
        return labels

    def _apply_locked(self, node: str, job, entry: Dict) -> None:
        kind = entry["kind"]
        name = entry["name"]
        key = (node, name, tuple(sorted((entry.get("labels") or {}).items())))
        prev = self._applied.get(key)
        labels = self._labels_for(node, job, entry)
        if kind == "counter":
            value = float(entry["value"])
            delta = value - (float(prev["value"]) if prev else 0.0)
            if delta < 0:
                # node restart: its registry reset to zero and re-grew
                self._m_resets.inc()
                delta = value
            if delta:
                self.registry.counter(name, labels=labels).inc(delta)
            else:
                self.registry.counter(name, labels=labels)
        elif kind == "gauge":
            self.registry.gauge(name, labels=labels).set(float(entry["value"]))
        elif kind == "histogram":
            buckets = entry["buckets"]
            # bucket keys are the SOURCE's str(bound) spellings ("1", not
            # "1.0") — keep the original key per parsed bound so lookups
            # never miss on float formatting
            key_of = {float(b): b for b in buckets if b != "+inf"}
            bounds = tuple(sorted(key_of))
            h = self.registry.histogram(name, labels=labels, buckets=bounds)
            order = [key_of[b] for b in h.bounds] + ["+inf"]
            prev_buckets = (prev or {}).get("buckets") or {}
            deltas = [int(buckets.get(b, 0)) - int(prev_buckets.get(b, 0))
                      for b in order]
            count_d = int(entry["count"]) - int((prev or {}).get("count", 0))
            sum_d = float(entry["sum"]) - float((prev or {}).get("sum", 0.0))
            if any(d < 0 for d in deltas) or count_d < 0:
                # node restart: re-apply the whole new histogram
                self._m_resets.inc()
                deltas = [int(buckets.get(b, 0)) for b in order]
                count_d = int(entry["count"])
                sum_d = float(entry["sum"])
            if count_d:
                h.merge_delta(deltas, count_d, sum_d,
                              observed_min=entry.get("min"),
                              observed_max=entry.get("max"))
        else:
            raise ValueError(f"unknown metric kind {kind!r}")
        self._applied[key] = entry

    # -- reads -------------------------------------------------------------
    def nodes(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {
                n: {"seq": s, "last_ts": self._last_ts.get(n),
                    "seq_gaps": self._gaps.get(n, 0)}
                for n, s in sorted(self._last_seq.items())
            }

    def snapshot(self) -> List[Dict]:
        return self.registry.snapshot()

    def value(self, name: str, **labels) -> Optional[float]:
        """Latest merged value of a counter/gauge (None if absent)."""
        for rec in self.registry.snapshot():
            if rec["name"] != name:
                continue
            lab = rec.get("labels") or {}
            if all(lab.get(k) == v for k, v in labels.items()):
                return float(rec.get("value", rec.get("count", 0)) or 0)
        return None

    def export_prometheus(self, include_plane: bool = True) -> str:
        """Aggregate node metrics + (optionally) this process's own
        ``live/*`` plane-health instruments."""
        text = self.registry.export_prometheus()
        if include_plane:
            plane = get_registry().export_prometheus(name_prefix="live/")
            if plane.strip():
                text = text.rstrip("\n") + "\n" + plane
        return text

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "job": self.job,
                "nodes": len(self._last_seq),
                "frames": int(self._m_ingested.value),
                "duplicate_frames": int(self._m_dup.value),
                "seq_gaps": int(self._m_gaps.value),
                "uptime_s": round(time.time() - self.started, 1),
            }
