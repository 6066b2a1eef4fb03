"""Typed metrics registry — Counter / Gauge / Histogram.

The port's own copy of ``fedml_tpu/telemetry/registry.py``: thread-safe
typed instruments with fixed histogram bucket boundaries, exported as JSONL
(the run-dir sink ``telemetry report`` reads, line for line the reference's
format, so either package's report reads either package's run dir) and as
Prometheus text exposition (what the inference runner serves at
``/metrics``). Metric names are ``/``-separated lowercase segments
(``serving/ttft_ms``), the span layer's taxonomy.
"""
from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-z0-9_]+(/[a-z0-9_]+)*$")

# Latency buckets in milliseconds; the +inf bucket is implicit.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000, 30000, 60000, 300000,
)

# Byte-size buckets: 64 B frames through GB-scale model payloads.
BYTES_BUCKETS: Tuple[float, ...] = (
    64, 256, 1024, 4096, 16384, 65536, 262144, 1048576,
    4194304, 16777216, 67108864, 268435456, 1073741824,
)


class Counter:
    """Monotonic counter. ``inc`` only; negative increments are rejected."""

    kind = "counter"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (inc {n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict:
        return {"kind": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins instantaneous value."""

    kind = "gauge"

    def __init__(self, name: str, lock: threading.Lock):
        self.name = name
        self._lock = lock
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def snapshot(self) -> Dict:
        return {"kind": self.kind, "value": self.value}


class Histogram:
    """Fixed-boundary histogram with percentile estimation.

    Percentiles are estimated Prometheus-style: find the bucket holding the
    target rank and interpolate linearly inside it (the +inf bucket clamps
    to the observed max).
    """

    kind = "histogram"

    def __init__(self, name: str, lock: threading.Lock,
                 buckets: Optional[Tuple[float, ...]] = None):
        self.name = name
        self._lock = lock
        bounds = tuple(sorted(buckets or DEFAULT_BUCKETS_MS))
        if not bounds:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +1 → the +inf bucket
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def _percentile_locked(self, q: float) -> float:
        if self._count == 0:
            return 0.0
        rank = q * self._count
        seen = 0
        lo = 0.0
        for i, b in enumerate(self.bounds):
            c = self._counts[i]
            if seen + c >= rank:
                frac = (rank - seen) / max(c, 1)
                return min(lo + (b - lo) * frac, self._max)
            seen += c
            lo = b
        return self._max  # rank lands in the +inf bucket

    def percentile(self, q: float) -> float:
        with self._lock:
            return self._percentile_locked(q)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> Dict:
        with self._lock:
            empty = self._count == 0
            return {
                "kind": self.kind,
                "count": self._count,
                "sum": self._sum,
                "min": 0.0 if empty else self._min,
                "max": 0.0 if empty else self._max,
                "p50": self._percentile_locked(0.50),
                "p95": self._percentile_locked(0.95),
                "p99": self._percentile_locked(0.99),
                "buckets": dict(zip([*map(str, self.bounds), "+inf"],
                                    self._counts)),
            }

    def merge_delta(self, bucket_deltas: List[int], count_delta: int,
                    sum_delta: float, observed_min: Optional[float] = None,
                    observed_max: Optional[float] = None) -> None:
        """Fold another histogram's delta into this one. ``bucket_deltas``
        aligns with ``bounds`` plus the +inf bucket; min and max are the
        other side's observed extremes, so they merge as min and max."""
        if len(bucket_deltas) != len(self._counts):
            raise ValueError(
                f"histogram {self.name}: merge of {len(bucket_deltas)} "
                f"buckets into {len(self._counts)}")
        with self._lock:
            for i, d in enumerate(bucket_deltas):
                self._counts[i] += int(d)
            self._count += int(count_delta)
            self._sum += float(sum_delta)
            if observed_min is not None:
                self._min = min(self._min, float(observed_min))
            if observed_max is not None:
                self._max = max(self._max, float(observed_max))


def _labels_key(labels: Optional[Dict[str, str]]) -> Tuple:
    return tuple(sorted((labels or {}).items()))


class MetricsRegistry:
    """Process-local, thread-safe registry of typed instruments.

    One instrument per (name, labels); re-requesting returns the existing
    one, and requesting an existing name with a different type raises.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[Tuple[str, Tuple], object] = {}

    def _get(self, cls, name: str, labels, **kw):
        if not _NAME_RE.match(name):
            raise ValueError(
                f"metric name {name!r} violates the taxonomy "
                "(lowercase [a-z0-9_] segments joined by '/')")
        key = (name, _labels_key(labels))
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls(name, threading.Lock(), **kw)
                m.labels = dict(labels or {})
                self._metrics[key] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}")
            return m

    def counter(self, name: str, labels: Optional[Dict[str, str]] = None) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, labels: Optional[Dict[str, str]] = None) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, labels: Optional[Dict[str, str]] = None,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(Histogram, name, labels, buckets=buckets)

    def total(self, name: str) -> float:
        """A counter's value summed over all its label sets (0 when none)."""
        return float(sum(m.value for m in self._items()
                         if m.name == name and isinstance(m, Counter)))

    def _items(self) -> List:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def snapshot(self) -> List[Dict]:
        return [{"name": m.name, "labels": m.labels, **m.snapshot()}
                for m in self._items()]

    def export_jsonl(self) -> List[str]:
        ts = time.time()
        return [json.dumps({"ts": ts, **rec}) for rec in self.snapshot()]

    def flush_jsonl(self, run_dir: str, filename: str = "telemetry.jsonl") -> str:
        """Append a snapshot of every instrument to the run-dir sink, in one
        ``write`` (processes sharing a run dir append whole lines)."""
        os.makedirs(run_dir, exist_ok=True)
        path = os.path.join(run_dir, filename)
        lines = "".join(line + "\n" for line in self.export_jsonl())
        with open(path, "a") as f:
            f.write(lines)
        return path

    def export_prometheus(self, name_prefix: Optional[str] = None) -> str:
        """Prometheus text exposition format, version 0.0.4; ``name_prefix``
        restricts the export to one metric namespace."""
        out: List[str] = []
        seen_types = set()
        for m in self._items():
            if name_prefix is not None and not m.name.startswith(name_prefix):
                continue
            pname = m.name.replace("/", "_")
            if pname not in seen_types:
                seen_types.add(pname)
                out.append(f"# TYPE {pname} {m.kind}")
            lbl = ",".join(f'{k}="{v}"' for k, v in sorted(m.labels.items()))
            suffix = "{" + lbl + "}" if lbl else ""
            if isinstance(m, Histogram):
                snap = m.snapshot()
                cum = 0
                for bound, c in snap["buckets"].items():
                    cum += c
                    le = f'le="{bound}"'
                    blbl = "{" + (lbl + "," if lbl else "") + le + "}"
                    out.append(f"{pname}_bucket{blbl} {cum}")
                out.append(f"{pname}_sum{suffix} {snap['sum']}")
                out.append(f"{pname}_count{suffix} {snap['count']}")
            else:
                out.append(f"{pname}{suffix} {m.value}")
        return "\n".join(out) + "\n"


_GLOBAL: Optional[MetricsRegistry] = None
_GLOBAL_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            _GLOBAL = MetricsRegistry()
        return _GLOBAL


def set_registry(registry: MetricsRegistry) -> None:
    global _GLOBAL
    with _GLOBAL_LOCK:
        _GLOBAL = registry


def reset_registry() -> None:
    """Drop the process-global registry (test isolation)."""
    set_registry(MetricsRegistry())
