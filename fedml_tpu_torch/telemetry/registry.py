"""Typed metrics registry — Counter / Gauge / Histogram.

The port's own copy of the instrument part of
``fedml_tpu/telemetry/registry.py`` that the serving engine, model slots
and endpoint monitor use: thread-safe typed instruments with fixed
histogram bucket boundaries, and the Prometheus text exposition the
inference runner serves at ``/metrics``. Metric names are
``/``-separated lowercase segments (``serving/ttft_ms``).
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-z0-9_]+(/[a-z0-9_]+)*$")

# Latency buckets in milliseconds; the +inf bucket is implicit.
DEFAULT_BUCKETS_MS: Tuple[float, ...] = (
    0.5, 1, 2.5, 5, 10, 25, 50, 100, 250, 500,
    1000, 2500, 5000, 10000, 30000, 60000, 300000,
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

    def export_prometheus(self) -> str:
        """Prometheus text exposition format, version 0.0.4."""
        out: List[str] = []
        seen_types = set()
        for m in self._items():
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
