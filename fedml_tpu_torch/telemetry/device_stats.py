"""Device memory introspection — phase-attributed memory gauges. The
port's twin of ``fedml_tpu/telemetry/device_stats.py``.

On the card a snapshot reads the CUDA caching allocator
(``torch.cuda.memory_stats()``: bytes allocated, reserved and the peak)
and ``torch.cuda.mem_get_info()`` (the card's memory, the limit). On the
CPU it reads the process RSS only. The reference also sums every live JAX
buffer (``jax.live_arrays``); torch has no cheap counterpart (a walk over
the garbage collector's objects), so ``live_buffer_bytes`` is the
allocator's allocated bytes on the card and 0 on the CPU. Every sample
is attributed to a *phase* (``train`` / ``aggregate`` / ``eval`` ...).

Each sample lands three ways:

- ``mem/*`` gauges in the metrics registry, labelled ``{phase}``;
- one ``mem_sample`` event (with the round index) in
  ``<run_dir>/health.jsonl``;
- the flight-recorder ring, so a crash dump shows where memory stood.

Where the reference counts XLA's compilation-cache traffic, the port
counts the build cache of its kernels (``ops/_build.py``):
``build/cache_hits``, ``build/cache_misses`` and ``build/cache_requests``.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.registry import get_registry

__all__ = [
    "DeviceStatsSampler",
    "install_compile_cache_counters",
    "memory_snapshot",
    "sample_now",
]

_PAGE_SIZE = os.sysconf("SC_PAGE_SIZE") if hasattr(os, "sysconf") else 4096

_cache_counters_installed = False
_cache_counters_lock = threading.Lock()


def _on_build_request(hit: bool) -> None:
    reg = get_registry()
    reg.counter("build/cache_requests").inc()
    reg.counter("build/cache_hits" if hit else "build/cache_misses").inc()


def install_compile_cache_counters() -> None:
    """Count the kernel build cache's hits and misses as typed counters
    (installed once per process; the builds themselves are the
    ``build/compile_ms`` histogram the span layer keeps)."""
    global _cache_counters_installed
    with _cache_counters_lock:
        if _cache_counters_installed:
            return
        from fedml_tpu_torch.ops import _build

        _build.add_cache_listener(_on_build_request)
        _cache_counters_installed = True


def _host_rss_bytes() -> float:
    """Current resident set size (Linux /proc; 0 where unreadable)."""
    try:
        with open("/proc/self/statm") as f:
            return float(int(f.read().split()[1]) * _PAGE_SIZE)
    except (OSError, ValueError, IndexError):
        return 0.0


def memory_snapshot() -> Dict[str, float]:
    """One memory reading, no gauges touched.

    ``bytes_in_use`` / ``peak_bytes`` / ``bytes_limit`` sum the allocator
    stats of every CUDA device this process initialised and stay 0 on the
    CPU; ``host_rss_bytes`` is always populated. On the card the snapshot
    also carries ``bytes_reserved`` (the allocator's cached segments)."""
    in_use = peak = limit = reserved = 0.0
    have_device_stats = False
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for dev in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(dev)
            if not stats:
                continue
            have_device_stats = True
            in_use += float(stats.get("allocated_bytes.all.current", 0))
            peak += float(stats.get("allocated_bytes.all.peak", 0))
            reserved += float(stats.get("reserved_bytes.all.current", 0))
            limit += float(torch.cuda.mem_get_info(dev)[1])
    snap = {
        "bytes_in_use": in_use,
        "peak_bytes": peak,
        "bytes_limit": limit,
        "live_buffer_bytes": in_use,
        "host_rss_bytes": _host_rss_bytes(),
        "device_stats_available": have_device_stats,
    }
    if have_device_stats:
        snap["bytes_reserved"] = reserved
    if limit > 0:
        snap["utilization"] = in_use / limit
    return snap


class DeviceStatsSampler:
    """Phase-attributed memory sampling for a round-based engine.

    ``min_interval_s`` rate-limits per phase so a tight loop cannot turn
    introspection into a hot-path cost; round loops sample every call by
    default.
    """

    def __init__(self, registry=None, min_interval_s: float = 0.0):
        # a pinned registry is honoured; otherwise resolve per sample, so a
        # long-lived sampler follows registry resets
        self._pinned_reg = registry
        self.min_interval_s = float(min_interval_s)
        self._last_sample: Dict[str, float] = {}
        self._lock = threading.Lock()
        install_compile_cache_counters()

    @property
    def _reg(self):
        return self._pinned_reg or get_registry()

    def sample(self, phase: str, round_idx: Optional[int] = None,
               **extra: Any) -> Optional[Dict[str, float]]:
        now = time.time()
        with self._lock:
            last = self._last_sample.get(phase, 0.0)
            if self.min_interval_s and now - last < self.min_interval_s:
                return None
            self._last_sample[phase] = now
        snap = memory_snapshot()
        labels = {"phase": str(phase)}
        self._reg.gauge("mem/device_bytes_in_use", labels=labels).set(
            snap["bytes_in_use"])
        self._reg.gauge("mem/device_peak_bytes", labels=labels).set(
            snap["peak_bytes"])
        self._reg.gauge("mem/bytes_limit", labels=labels).set(
            snap["bytes_limit"])
        self._reg.gauge("mem/live_buffer_bytes", labels=labels).set(
            snap["live_buffer_bytes"])
        self._reg.gauge("mem/host_rss_bytes", labels=labels).set(
            snap["host_rss_bytes"])
        if "utilization" in snap:
            self._reg.gauge("mem/hbm_utilization", labels=labels).set(
                snap["utilization"])
        event = {"kind": "mem_sample", "phase": str(phase), **snap, **extra}
        if round_idx is not None:
            event["round"] = int(round_idx)
        from fedml_tpu_torch.telemetry.health import log_health_event

        log_health_event(event)
        flight_recorder.record(**event)
        # phase samples double as the profile/* refresh tick
        from fedml_tpu_torch.telemetry.profiling import pump_profile_gauges

        pump_profile_gauges()
        return snap


_default_sampler: Optional[DeviceStatsSampler] = None
_default_lock = threading.Lock()


def sample_now(phase: str, round_idx: Optional[int] = None,
               **extra: Any) -> Optional[Dict[str, float]]:
    """Sample through a shared process-global sampler — for call sites
    that own no engine."""
    global _default_sampler
    with _default_lock:
        if _default_sampler is None:
            _default_sampler = DeviceStatsSampler()
        sampler = _default_sampler
    return sampler.sample(phase, round_idx, **extra)
