"""Online doctor — post-hoc triage rules evaluated on the live stream (the
port's copy of ``fedml_tpu/telemetry/live/online_doctor.py``).

``telemetry doctor`` answers "what went wrong" after the run; the online
doctor answers it **while the run is still going**: it hangs off the
:class:`~fedml_tpu_torch.telemetry.live.collector.LiveCollector` as an ingest
hook and re-evaluates the same rule set incrementally on every applied
frame — straggling clients, memory growth slope, a serving endpoint
stuck on a stale round, quorum-degraded rounds, evicted nodes that never
rejoined. A tripped rule emits ONE alert (edge-triggered, deduped per
subject) the round the condition becomes true, landed in all three
places an operator might be watching:

- a ``doctor_alert`` record appended to ``<run_dir>/telemetry.jsonl``
  (the post-hoc doctor surfaces these in its ``live`` section, proving
  the alert fired mid-run, not in the autopsy);
- the flight recorder ring (a crash dump shows the alerts that preceded
  death);
- the ``live/alerts`` counter (labeled by rule) on the scrape endpoint.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.registry import get_registry

__all__ = ["OnlineDoctor"]


class OnlineDoctor:
    """Incremental triage over a live collector's merged registry."""

    def __init__(self, collector, run_dir: Optional[str] = None,
                 straggler_threshold: float = 2.0,
                 anomaly_threshold: float = 4.0,
                 mem_growth_threshold: float = 1.5,
                 min_rounds: int = 3,
                 stale_round_gap: int = 2,
                 rejoin_grace_rounds: int = 2,
                 slo_burn_threshold: float = 10.0,
                 slo_burn_windows_s: Tuple[float, ...] = (60.0, 300.0)):
        self.collector = collector
        self.run_dir = run_dir
        self.straggler_threshold = float(straggler_threshold)
        self.anomaly_threshold = float(anomaly_threshold)
        self.mem_growth_threshold = float(mem_growth_threshold)
        self.min_rounds = int(min_rounds)
        self.stale_round_gap = int(stale_round_gap)
        self.rejoin_grace_rounds = int(rejoin_grace_rounds)
        self.slo_burn_threshold = float(slo_burn_threshold)
        self.slo_burn_windows_s = tuple(
            sorted(float(w) for w in slo_burn_windows_s))
        self.alerts: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        # serializes rule evaluation: collector hooks fire outside the
        # collector's merge lock, and ingests arrive concurrently (comm
        # receive threads + ThreadingHTTPServer /ingest handlers) — the
        # per-rule history dicts below are not safe to race on
        self._eval_lock = threading.Lock()
        self._fired: set = set()
        self._mem_hist: Dict[Tuple, List[Tuple[int, float]]] = {}
        # (node, endpoint, objective) -> [(ts, slo_total, slo_breaches)]:
        # the cumulative-counter history the multi-window burn rate is
        # differenced from
        self._slo_hist: Dict[Tuple, List[Tuple[float, float, float]]] = {}
        self._quorum_seen: Dict[Tuple, float] = {}
        self._evict_epoch: Dict[str, Tuple[float, Optional[int]]] = {}
        self._rounds: Dict[str, int] = {}
        collector.add_hook(self._on_frame)

    # -- plumbing ----------------------------------------------------------
    @staticmethod
    def _per_node(by_name: Dict[str, List[Dict]],
                  name: str) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for rec in by_name.get(name, ()):
            node = (rec.get("labels") or {}).get("node", "?")
            out[node] = out.get(node, 0.0) + float(
                rec.get("value", rec.get("count", 0)) or 0)
        return out

    def _round_of(self, node: str) -> Optional[int]:
        """The node's current round: rounds_scored counts completed
        scoring passes, so the round that just closed is value - 1.
        Computed once per ingested frame from the snapshot the hook
        already holds — never a fresh registry scan per record."""
        v = self._rounds.get(node)
        return int(v) - 1 if v else None

    def _emit(self, rule: str, verdict: str, node: str,
              round_idx: Optional[int], dedupe: Tuple, **fields) -> None:
        key = (rule,) + dedupe
        with self._lock:
            if key in self._fired:
                return
            self._fired.add(key)
        alert = {
            "ts": time.time(),
            "kind": "doctor_alert",
            "rule": rule,
            "node": node,
            "round": round_idx,
            "verdict": verdict,
            **fields,
        }
        self.alerts.append(alert)
        get_registry().counter("live/alerts", labels={"rule": rule}).inc()
        flight_recorder.record("doctor_alert", rule=rule, node=node,
                               round=round_idx, verdict=verdict)
        # alert-triggered deep trace: straggler / memory-slope / serving-
        # stall alerts request ONE bounded capture for the next round on
        # the implicated (in-process) node — the TraceController dedupes
        # per rule per run and enforces the count/byte budget, so a
        # second alert on the same rule never re-captures
        from fedml_tpu_torch.telemetry.profiling import (
            AUTO_CAPTURE_RULES,
            get_trace_controller,
        )

        if rule in AUTO_CAPTURE_RULES:
            get_trace_controller().request_capture(
                rule=rule, reason=verdict, node=node, round_idx=round_idx)
        run_dir = self.run_dir
        if run_dir is None:
            from fedml_tpu_torch.telemetry.spans import get_tracer

            run_dir = get_tracer().sink_dir
        if run_dir is not None:
            try:
                os.makedirs(run_dir, exist_ok=True)
                with open(os.path.join(run_dir, "telemetry.jsonl"), "a") as f:
                    f.write(json.dumps(alert, default=str) + "\n")
            except OSError:  # pragma: no cover - sink dir gone
                pass

    # -- the hook ----------------------------------------------------------
    # the metric namespaces any rule reads: a frame carrying none of them
    # (comm counters, live/* plane health, serving wire stats...) cannot
    # change any rule's verdict, so it skips the registry snapshot + full
    # re-evaluation entirely — most steady-state frames take this exit
    _RULE_PREFIXES = ("health/", "mem/", "serving/", "resilience/", "tier/")

    def _on_frame(self, frame: Dict, collector) -> None:
        if not any(str(e.get("name", "")).startswith(self._RULE_PREFIXES)
                   for e in frame.get("metrics") or ()):
            return
        node = str(frame.get("node"))
        with self._eval_lock:
            recs = collector.snapshot()
            by_name: Dict[str, List[Dict]] = {}
            for rec in recs:
                by_name.setdefault(rec["name"], []).append(rec)
            self._rounds = self._per_node(by_name, "health/rounds_scored")
            self._check_stragglers(by_name)
            self._check_memory(by_name)
            self._check_serving(by_name)
            self._check_slo_burn(by_name)
            self._check_quorum(by_name)
            self._check_never_rejoined(by_name, node, self._round_of(node))

    # -- rules -------------------------------------------------------------
    def _check_stragglers(self, by_name: Dict[str, List[Dict]]) -> None:
        for metric, threshold, rule, text in (
                ("health/straggler_score", self.straggler_threshold,
                 "straggler", "latency {v:.1f}x the cohort median"),
                ("health/anomaly_score", self.anomaly_threshold,
                 "anomaly", "median update-norm/loss |z| {v:.1f}")):
            for rec in by_name.get(metric, ()):
                labels = rec.get("labels") or {}
                client = labels.get("client")
                node = labels.get("node", "?")
                v = float(rec.get("value") or 0.0)
                if client is None or v < threshold:
                    continue
                rnd = self._round_of(node)
                # the tracker's gauge is a median over scored rounds, but
                # a flag still needs min_rounds of evidence — mirror the
                # post-hoc doctor so the two can never disagree
                if rnd is None or rnd + 1 < self.min_rounds:
                    continue
                self._emit(
                    rule,
                    f"client {client} is a {rule}: " + text.format(v=v),
                    node, rnd, dedupe=(node, str(client)),
                    client=str(client), score=round(v, 3))

    def _check_memory(self, by_name: Dict[str, List[Dict]]) -> None:
        from fedml_tpu_torch.telemetry.doctor import _fit_slope

        for metric in ("mem/device_bytes_in_use", "mem/live_buffer_bytes"):
            for rec in by_name.get(metric, ()):
                labels = rec.get("labels") or {}
                node = labels.get("node", "?")
                phase = labels.get("phase", "")
                rnd = self._round_of(node)
                if rnd is None:
                    continue
                v = float(rec.get("value") or 0.0)
                if v <= 0:
                    continue
                key = (node, phase, metric)
                hist = self._mem_hist.setdefault(key, [])
                if not hist or hist[-1][0] != rnd:
                    hist.append((rnd, v))
                else:
                    hist[-1] = (rnd, v)
                if len(hist) < max(3, self.min_rounds):
                    continue
                first, last = hist[0][1], hist[-1][1]
                slope = _fit_slope([float(r) for r, _ in hist],
                                   [b for _, b in hist])
                if first > 0 and slope > 0 and (
                        last / first >= self.mem_growth_threshold):
                    self._emit(
                        "memory_growth",
                        f"memory grows in phase {phase!r} on {node}: "
                        f"{first:.0f} -> {last:.0f} bytes "
                        f"({slope:.0f} B/round)",
                        node, rnd, dedupe=(node, phase, metric),
                        phase=phase, metric=metric,
                        slope_bytes_per_round=round(slope, 1))

    def _check_serving(self, by_name: Dict[str, List[Dict]]) -> None:
        published = [float(r.get("value") or 0.0)
                     for r in by_name.get("serving/round_published", ())]
        if not published:
            return
        pub = max(published)
        for rec in by_name.get("serving/round_current", ()):
            labels = rec.get("labels") or {}
            node = labels.get("node", "?")
            cur = float(rec.get("value") or 0.0)
            if pub - cur >= self.stale_round_gap:
                # re-arming falls out of the dedupe key: a healed endpoint
                # advances cur, so a NEW stall dedupes on a new (node, cur)
                self._emit(
                    "stale_serving_round",
                    f"endpoint {node} serves round {cur:.0f} while training "
                    f"published round {pub:.0f} ({pub - cur:.0f} behind)",
                    node, int(pub), dedupe=(node, int(cur)),
                    round_current=int(cur), round_published=int(pub))

    def _check_slo_burn(self, by_name: Dict[str, List[Dict]]) -> None:
        """Multi-window error-budget burn rate (SRE-style) over the
        cumulative ``serving/slo_total`` / ``serving/slo_breaches``
        counter pairs each endpoint streams, labeled by objective.

        burn = (bad_delta / total_delta) / (1 - objective) over each
        window; the alert trips only when EVERY window has both spanned
        its full width (oldest history entry old enough) and burned at
        ``slo_burn_threshold`` or above — the short window makes the
        alert fast, the long window keeps a transient blip from paging.
        """
        def keyed(metric: str) -> Dict[Tuple, float]:
            out: Dict[Tuple, float] = {}
            for rec in by_name.get(metric, ()):
                labels = rec.get("labels") or {}
                key = (labels.get("node", "?"), labels.get("endpoint", "?"),
                       labels.get("objective", "?"))
                out[key] = float(rec.get("value", rec.get("count", 0)) or 0)
            return out

        totals = keyed("serving/slo_total")
        if not totals:
            return
        bads = keyed("serving/slo_breaches")
        objectives: Dict[Tuple, float] = {}
        for rec in by_name.get("serving/slo_objective", ()):
            labels = rec.get("labels") or {}
            objectives[(labels.get("node", "?"),
                        labels.get("endpoint", "?"))] = float(
                rec.get("value") or 0.0)
        now = time.time()
        long_w = self.slo_burn_windows_s[-1]
        for key, total in totals.items():
            node, endpoint, kind = key
            bad = bads.get(key, 0.0)
            hist = self._slo_hist.setdefault(key, [])
            hist.append((now, total, bad))
            # keep exactly one entry at/past the long-window boundary so
            # the difference stays well-defined without unbounded history
            while len(hist) >= 2 and hist[1][0] <= now - long_w:
                hist.pop(0)
            objective = objectives.get((node, endpoint), 0.99)
            budget = 1.0 - objective
            if budget <= 0:
                continue
            burns = []
            for w in self.slo_burn_windows_s:
                base = None
                for ts, t, b in hist:
                    if ts <= now - w:
                        base = (t, b)
                    else:
                        break
                if base is None:
                    burns = None  # window not spanned yet — can't judge
                    break
                d_total = total - base[0]
                d_bad = bad - base[1]
                bad_frac = d_bad / d_total if d_total > 0 else 0.0
                burns.append(bad_frac / budget)
            if burns is None or min(burns) < self.slo_burn_threshold:
                continue
            rnd = self._round_of(node)
            self._emit(
                "slo_burn",
                f"{endpoint} on {node} burns its {kind} error budget at "
                f"{burns[0]:.1f}x (long window {burns[-1]:.1f}x, "
                f"objective {objective:g})",
                node, rnd, dedupe=(node, endpoint, kind),
                endpoint=endpoint, objective=kind,
                burn=round(burns[0], 2), burn_long=round(burns[-1], 2),
                budget=round(budget, 4),
                windows_s=list(self.slo_burn_windows_s))

    def _check_quorum(self, by_name: Dict[str, List[Dict]]) -> None:
        for name, recs in by_name.items():
            is_quorum = (name == "resilience/quorum_rounds"
                         or (name.startswith("tier/")
                             and name.endswith("/quorum_failures")))
            if not is_quorum:
                continue
            for rec in recs:
                labels = rec.get("labels") or {}
                node = labels.get("node", "?")
                v = float(rec.get("value") or 0.0)
                key = (node, name)
                prev = self._quorum_seen.get(key, 0.0)
                if v > prev:
                    self._quorum_seen[key] = v
                    rnd = self._round_of(node)
                    what = ("round closed on quorum after its deadline"
                            if name == "resilience/quorum_rounds"
                            else f"cohort close fell below quorum ({name})")
                    self._emit(
                        "quorum", f"{node}: {what} (total {v:.0f})",
                        node, rnd, dedupe=(node, name, int(v)),
                        counter=name, total=v)

    def _check_never_rejoined(self, by_name: Dict[str, List[Dict]],
                              node: str, round_idx: Optional[int]) -> None:
        ev = self._per_node(by_name, "resilience/clients_evicted").get(node)
        rj = self._per_node(by_name, "resilience/clients_rejoined").get(node)
        deficit = (ev or 0.0) - (rj or 0.0)
        epoch = self._evict_epoch.get(node)
        if deficit <= 0:
            self._evict_epoch.pop(node, None)
            return
        if epoch is None or epoch[0] != deficit:
            # new deficit level: start (or restart) the rejoin grace clock
            self._evict_epoch[node] = (deficit, round_idx)
            return
        start_round = epoch[1]
        if (round_idx is not None and start_round is not None
                and round_idx - start_round >= self.rejoin_grace_rounds):
            self._emit(
                "never_rejoined",
                f"{node}: {deficit:.0f} evicted client(s) have not "
                f"rejoined after {round_idx - start_round} round(s)",
                node, round_idx, dedupe=(node, deficit, start_round),
                evicted=ev, rejoined=rj)

    # -- reads -------------------------------------------------------------
    def snapshot(self) -> List[Dict[str, Any]]:
        return list(self.alerts)
