"""Endpoint monitor — liveness + rolling latency/throughput stats.

Counterpart of ``fedml_tpu/serving/monitor.py``. Every stat lives in the
port's metrics registry — counters for request/error totals, histograms
for request latency, TTFT and inter-token (TPOT) latency, gauges for uptime
and last activity — and :meth:`snapshot` reads those instruments. A
:class:`ServingSLO` gives per-objective targets (TTFT / TPOT / e2e + the
objective fraction); each observation is scored into cumulative
``serving/slo_total`` / ``serving/slo_breaches`` counters. The MLOps
metrics mirror and the shed-burst ``serving_event`` record wait for the
telemetry item of the ROADMAP (A12).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterator, Optional, Tuple

from fedml_tpu_torch.telemetry import get_registry


@dataclass
class ServingSLO:
    """Per-endpoint latency objectives: targets in ms (0 = undeclared)
    plus the objective fraction (0.99 → 1% error budget)."""

    ttft_ms: float = 0.0
    tpot_ms: float = 0.0
    e2e_ms: float = 0.0
    objective: float = 0.99

    def targets(self) -> Iterator[Tuple[str, float]]:
        """The declared (objective_name, target_ms) pairs."""
        for kind, target in (("ttft", self.ttft_ms), ("tpot", self.tpot_ms),
                             ("e2e", self.e2e_ms)):
            if target and target > 0:
                yield kind, float(target)

    def __bool__(self) -> bool:
        return any(True for _ in self.targets())


class EndpointMonitor:
    def __init__(self, endpoint_id: str = "default",
                 slo: Optional[ServingSLO] = None):
        self.endpoint_id = endpoint_id
        self.slo = slo if slo is not None else ServingSLO()
        self._started = time.time()
        reg = get_registry()
        labels = {"endpoint": endpoint_id}
        self._g_slo = reg.gauge("serving/slo_ms", labels=labels)
        self._g_slo.set(float(self.slo.e2e_ms or 0))
        self._g_slo_objective = reg.gauge("serving/slo_objective", labels=labels)
        self._g_slo_objective.set(float(self.slo.objective))
        self._slo_counters: Dict[str, Tuple] = {}
        for kind, target in self.slo.targets():
            klabels = {**labels, "objective": kind}
            reg.gauge("serving/slo_target_ms", labels=klabels).set(target)
            self._slo_counters[kind] = (
                target,
                reg.counter("serving/slo_total", labels=klabels),
                reg.counter("serving/slo_breaches", labels=klabels),
            )
        self._hist = reg.histogram("serving/request_ms", labels=labels)
        self._m_requests = reg.counter("serving/requests", labels=labels)
        self._m_errors = reg.counter("serving/errors", labels=labels)
        self._g_uptime = reg.gauge("serving/uptime_s", labels=labels)
        self._g_uptime.set(0.0)
        self._g_last_request = reg.gauge("serving/last_request_ts", labels=labels)
        self._g_round = reg.gauge("serving/round_current", labels=labels)
        self._c_swaps = reg.counter("serving/swaps", labels=labels)
        self._h_swap_stall = reg.histogram("serving/swap_stall_ms", labels=labels)
        self._c_rejected = reg.counter("serving/rejected", labels=labels)
        self._h_ttft = reg.histogram("serving/ttft_ms", labels=labels)
        self._h_tpot = reg.histogram("serving/tpot_ms", labels=labels)
        self._g_tps = reg.gauge("serving/tokens_per_s", labels=labels)
        self._h_queue_wait = reg.histogram("serving/queue_wait_ms", labels=labels)
        # instruments are cumulative per (endpoint, process): baselines make
        # snapshot() report THIS deployment's counts and average
        self._base_rejected = self._c_rejected.value
        self._base_swaps = self._c_swaps.value
        self._base_requests = self._m_requests.value
        self._base_errors = self._m_errors.value
        base = self._hist.snapshot()
        self._base_lat_sum = base["sum"]
        self._base_lat_count = base["count"]

    def _note_slo(self, kind: str, value_ms: float) -> None:
        entry = self._slo_counters.get(kind)
        if entry is None:
            return
        target, c_total, c_bad = entry
        c_total.inc()
        if value_ms > target:
            c_bad.inc()

    def record_request(self, latency_s: float, ok: bool = True) -> None:
        self._hist.observe(latency_s * 1e3)
        self._m_requests.inc()
        if not ok:
            self._m_errors.inc()
        self._note_slo("e2e", latency_s * 1e3)
        now = time.time()
        self._g_last_request.set(now)
        self._g_uptime.set(round(now - self._started, 1))

    def record_stream(self, ttft_ms: float, tpot_ms, tokens_per_s: float) -> None:
        """One finished stream's TTFT, inter-token intervals and rate."""
        self._h_ttft.observe(float(ttft_ms))
        self._note_slo("ttft", float(ttft_ms))
        for v in tpot_ms:
            self._h_tpot.observe(float(v))
            self._note_slo("tpot", float(v))
        self._g_tps.set(round(float(tokens_per_s), 3))

    def record_queue_wait(self, wait_ms: float) -> None:
        self._h_queue_wait.observe(float(wait_ms))

    def record_swap(self, round_idx: int) -> None:
        self._g_round.set(float(round_idx))
        self._c_swaps.inc()

    def record_swap_stall(self, round_idx: int, stall_ms: float) -> None:
        self._h_swap_stall.observe(float(stall_ms))

    def record_rejected(self, queue_depth: Optional[int] = None) -> None:
        """A request was shed with 429 by the bounded admission gate."""
        self._c_rejected.inc()
        self._g_last_request.set(time.time())

    def snapshot(self) -> Dict:
        hist = self._hist.snapshot()
        uptime = round(time.time() - self._started, 1)
        self._g_uptime.set(uptime)
        n = max(hist["count"] - self._base_lat_count, 1)
        last_ts = self._g_last_request.value
        snap = {
            "endpoint_id": self.endpoint_id,
            "requests": int(self._m_requests.value - self._base_requests),
            "errors": int(self._m_errors.value - self._base_errors),
            "latency_avg_ms": round((hist["sum"] - self._base_lat_sum) / n, 3),
            "latency_max_ms": round(hist["max"], 3),
            "latency_p50_ms": round(hist["p50"], 3),
            "latency_p95_ms": round(hist["p95"], 3),
            "latency_p99_ms": round(hist["p99"], 3),
            "uptime_s": uptime,
            "last_request_ts": last_ts or None,
            "rejected": int(self._c_rejected.value - self._base_rejected),
            "swaps": int(self._c_swaps.value - self._base_swaps),
            "round_current": (int(self._g_round.value)
                              if self._c_swaps.value - self._base_swaps
                              else None),
        }
        stall = self._h_swap_stall.snapshot()
        if stall["count"]:
            snap["swap_stall_max_ms"] = round(stall["max"], 3)
        ttft = self._h_ttft.snapshot()
        if ttft["count"]:
            tpot = self._h_tpot.snapshot()
            snap["ttft_p95_ms"] = round(ttft["p95"], 3)
            snap["tpot_p95_ms"] = round(tpot["p95"], 3)
            snap["tokens_per_s"] = self._g_tps.value
        if self._slo_counters:
            snap["slo"] = {
                kind: {"target_ms": target, "total": int(c_total.value),
                       "breaches": int(c_bad.value)}
                for kind, (target, c_total, c_bad) in self._slo_counters.items()
            }
        return snap
