"""The run report — turns a run dir's JSONL sinks into a timeline.

The port's twin of ``fedml_tpu/telemetry/report.py``. It reads the files
the telemetry layer writes under ``<log_file_dir>/run_<id>/``:

- ``spans.jsonl``     — tracer spans (round and client phases, comm dispatch)
- ``events.jsonl``    — MLOpsProfilerEvent spans (the facade's output)
- ``telemetry.jsonl`` — metrics-registry snapshots (counters, gauges, histograms)
- ``metrics.jsonl``   — MLOpsMetrics records (accuracy and loss per round)

and gives each round's wall, each phase's p50/p95 (from the raw spans, not
bucket estimates), the slowest client of each round, the kernel-build vs
execute split, the comm-bytes breakdown and the spans stitched across
processes. Its keys are the reference's, and it reads either package's
run dir, and joins ``programs.jsonl`` (the program catalog) against the
phase walls into the roofline attribution, and shows the ``health/*``
gauges the client health tracker sets. The critical path is the
per-round walk of the assembled trace (``telemetry.tracing``) over
``spans.jsonl`` and the live plane's ``spans_remote.jsonl``, with each
node's clock.
"""
from __future__ import annotations

import json
import os
import re
from typing import Dict, List

_ROUND_RE = re.compile(r"^round/(\d+)(?:/|$)")
_CLIENT_RE = re.compile(r"^round/\d+/client/([^/]+)/")
_NUM_SEG = re.compile(r"(?<=/)\d+(?=/|$)|^\d+(?=/|$)")


def _load_jsonl(path: str) -> List[Dict]:
    if not os.path.exists(path):
        return []
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except ValueError:
                continue  # torn tail line from a crashed writer
    return out


def normalize_name(name: str) -> str:
    """Collapse numeric ids to taxonomy placeholders:
    ``round/3/client/7/train`` → ``round/<n>/client/<id>/train``."""
    name = re.sub(r"^round/\d+", "round/<n>", name)
    name = re.sub(r"/client/[^/]+/", "/client/<id>/", name)
    name = _NUM_SEG.sub("<n>", name)
    return name


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = q * (len(sorted_vals) - 1)
    lo = int(idx)
    hi = min(lo + 1, len(sorted_vals) - 1)
    frac = idx - lo
    return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac


def _spans_from_raw(spans_raw: List[Dict], events_raw: List[Dict]
                    ) -> List[Dict]:
    spans = list(spans_raw)
    for e in events_raw:
        # legacy event records: {"event", "edge_id", started/ended/duration}
        if "event" in e and "name" not in e:
            e = dict(e)
            e["name"] = f"event/{e.pop('event')}"
        spans.append(e)
    return [s for s in spans if "name" in s and "duration_ms" in s]


class RunData:
    """Single-pass shared load of a run dir's JSONL sinks.

    Every sink file is parsed at most once, whoever asks first; the
    report's sections, the doctor, and the trace assembler all consume
    the same cached parse. Build one per run dir and pass it to
    ``build_report``/``build_doctor`` when composing them (the CLI's
    ``doctor`` builds the report internally and would otherwise re-read
    every file)."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        self._raw: Dict[str, List[Dict]] = {}

    def raw(self, filename: str) -> List[Dict]:
        if filename not in self._raw:
            self._raw[filename] = _load_jsonl(
                os.path.join(self.run_dir, filename))
        return self._raw[filename]

    @property
    def spans(self) -> List[Dict]:
        return _spans_from_raw(self.raw("spans.jsonl"),
                               self.raw("events.jsonl"))

    @property
    def metrics(self) -> List[Dict]:
        return self.raw("telemetry.jsonl")

    @property
    def programs(self) -> List[Dict]:
        return self.raw("programs.jsonl")

    @property
    def health(self) -> List[Dict]:
        return self.raw("health.jsonl")

    @property
    def flight(self) -> List[Dict]:
        return self.raw("flight_recorder.jsonl")

    @property
    def trace_records(self) -> List[Dict]:
        """Raw span and point-event records: the local sink plus the live
        plane's node-annotated remote sink."""
        from fedml_tpu_torch.telemetry.tracing.assemble import REMOTE_SPANS_FILENAME

        return self.raw("spans.jsonl") + self.raw(REMOTE_SPANS_FILENAME)


def load_spans(run_dir: str) -> List[Dict]:
    return _spans_from_raw(
        _load_jsonl(os.path.join(run_dir, "spans.jsonl")),
        _load_jsonl(os.path.join(run_dir, "events.jsonl")))


def load_metrics(run_dir: str) -> List[Dict]:
    return _load_jsonl(os.path.join(run_dir, "telemetry.jsonl"))


def load_programs(run_dir: str) -> List[Dict]:
    """``programs.jsonl`` — the per-run program-catalog snapshot (one
    line per named XLA program; the file is rewritten whole at flush, so
    every line is current)."""
    return _load_jsonl(os.path.join(run_dir, "programs.jsonl"))


def build_report(run_dir) -> Dict:
    data = run_dir if isinstance(run_dir, RunData) else RunData(run_dir)
    run_dir = data.run_dir
    spans = data.spans
    metrics = data.metrics

    # partial runs degrade to explicit per-section notes, not tracebacks:
    # a crashed writer leaves missing/truncated sinks and the report must
    # still triage whatever did land
    notes: Dict[str, str] = {}
    if not spans:
        have = [f for f in ("spans.jsonl", "events.jsonl")
                if os.path.exists(os.path.join(run_dir, f))]
        notes["spans"] = (
            "no data: " + (" and ".join(have) + " present but empty/"
                           "unparseable" if have
                           else "spans.jsonl/events.jsonl missing"))
    if not metrics:
        notes["metrics"] = (
            "no data: telemetry.jsonl "
            + ("present but empty/unparseable" if os.path.exists(
                os.path.join(run_dir, "telemetry.jsonl")) else "missing"))

    # -- per-round timeline (one pass; client spans collected for the
    # straggler section as we go) ----------------------------------------
    rounds: Dict[int, Dict] = {}
    for s in spans:
        m = _ROUND_RE.match(s["name"])
        if not m:
            continue
        n = int(m.group(1))
        phase = normalize_name(s["name"])
        prefetch = phase.endswith("/prefetch")
        r = rounds.get(n)
        if r is None:
            r = rounds[n] = {"round": n, "started": None, "ended": None,
                             "phases": {}, "client_spans": []}
        # prefetch spans run DURING the previous round (that is the
        # point) — counting them into this round's wall bounds would
        # overlap consecutive rounds and double-count execute time; they
        # get the dedicated stage_overlap section instead
        if not prefetch:
            r["started"] = (s["started"] if r["started"] is None
                            else min(r["started"], s["started"]))
            r["ended"] = (s["ended"] if r["ended"] is None
                          else max(r["ended"], s["ended"]))
        r["phases"].setdefault(phase, []).append(s["duration_ms"])
        if _CLIENT_RE.match(s["name"]):
            r["client_spans"].append(s)
    round_rows = []
    for n in sorted(rounds):
        r = rounds[n]
        # a round with only a prefetch span (staged but never dispatched,
        # e.g. an aborted run) has no wall bounds
        wall_ms = ((r["ended"] - r["started"]) * 1e3
                   if r["started"] is not None else 0.0)
        round_rows.append({
            "round": n,
            "wall_ms": wall_ms,
            "phases": {p: sum(v) for p, v in sorted(r["phases"].items())},
        })

    # -- per-phase percentiles over the whole run -------------------------
    by_phase: Dict[str, List[float]] = {}
    for s in spans:
        by_phase.setdefault(normalize_name(s["name"]), []).append(
            s["duration_ms"])
    phase_rows = []
    for phase in sorted(by_phase):
        vals = sorted(by_phase[phase])
        phase_rows.append({
            "phase": phase,
            "count": len(vals),
            "p50_ms": _pct(vals, 0.50),
            "p95_ms": _pct(vals, 0.95),
            "p99_ms": _pct(vals, 0.99),
            "total_ms": sum(vals),
        })

    # -- straggler attribution -------------------------------------------
    stragglers = []
    for n in sorted(rounds):
        client_spans = rounds[n]["client_spans"]
        if not client_spans:
            continue
        worst = max(client_spans, key=lambda s: s["duration_ms"])
        total = sum(s["duration_ms"] for s in client_spans)
        stragglers.append({
            "round": n,
            "client": _CLIENT_RE.match(worst["name"]).group(1),
            "duration_ms": worst["duration_ms"],
            "share": worst["duration_ms"] / total if total else 0.0,
        })

    # -- stage overlap (pipelined round engine) ---------------------------
    # how much of round r's host staging (the round/<r>/prefetch span,
    # recorded on the prefetch worker) ran while round r-1's program was
    # in flight. Rounds chain without a host barrier, so the device-busy
    # window for round r-1 is approximated by the wall interval between
    # consecutive train_agg dispatches — the chained-timing caveat from
    # PERF_NOTES applies (host spans cannot see device queue drain).
    ta_by_round: Dict[int, Dict] = {}
    prefetch_by_round: Dict[int, Dict] = {}
    for s in spans:
        m = _ROUND_RE.match(s["name"])
        if not m:
            continue
        n = int(m.group(1))
        tail = normalize_name(s["name"])
        if tail == "round/<n>/train_agg":
            ta_by_round.setdefault(n, s)
        elif tail == "round/<n>/prefetch":
            prefetch_by_round.setdefault(n, s)
    overlap_rows = []
    for n in sorted(prefetch_by_round):
        # rounds chain: the device is (assumed) busy from the FIRST prior
        # dispatch through the dispatch of round n, not just since n-1 —
        # prefetch(n) legitimately starts a hair before dispatch(n-1)
        # while rounds < n-1 are still in flight
        prior = [t for k, t in ta_by_round.items() if k < n]
        if not prior:
            continue
        p = prefetch_by_round[n]
        cur = ta_by_round.get(n)
        win_end = (cur["started"] if cur is not None
                   else max(t["ended"] for t in prior))
        lo = max(p["started"], min(t["started"] for t in prior))
        hi = min(p["ended"], win_end)
        dur_ms = max(p["duration_ms"], 1e-9)
        overlapped_ms = max(0.0, hi - lo) * 1e3
        overlap_rows.append({
            "round": n,
            "prefetch_ms": p["duration_ms"],
            "overlapped_ms": overlapped_ms,
            "ratio": min(overlapped_ms / dur_ms, 1.0),
        })
    total_prefetch = sum(r["prefetch_ms"] for r in overlap_rows)
    total_overlap = sum(r["overlapped_ms"] for r in overlap_rows)
    stage_overlap = {
        "rounds": overlap_rows,
        "prefetch_ms": total_prefetch,
        "overlapped_ms": total_overlap,
        "ratio": (total_overlap / total_prefetch) if total_prefetch else 0.0,
    }

    # -- compile vs execute ----------------------------------------------
    compile_ms = sum(s.get("compile_ms", 0.0) for s in spans)
    round_total = sum(r["wall_ms"] for r in round_rows)

    # -- comm bytes (latest snapshot per metric name+labels) --------------
    comm: Dict[str, float] = {}
    for rec in metrics:
        name = rec.get("name", "")
        if rec.get("kind") == "counter" and (
                name.startswith("broker/") or name.startswith("comm/")):
            lbl = ",".join(f"{k}={v}"
                           for k, v in sorted((rec.get("labels") or {}).items()))
            comm[name + ("{" + lbl + "}" if lbl else "")] = rec["value"]

    # -- compression ratio (raw payload bytes vs what hit the wire) -------
    def _sum_counter(prefix: str) -> float:
        return sum(v for name, v in comm.items()
                   if name.split("{")[0] == prefix)

    raw_bytes = _sum_counter("comm/raw_bytes")
    wire_bytes = (_sum_counter("comm/wire_bytes_out")
                  + _sum_counter("comm/offload_wire_bytes"))
    codec_phases = {
        p["phase"]: p for p in phase_rows
        if p["phase"].startswith("compress/")
    }
    compression = {
        "raw_bytes": raw_bytes,
        "wire_bytes": wire_bytes,
        # wire counters include control-frame overhead, so the ratio is a
        # lower bound on the payload compression factor
        "ratio": (raw_bytes / wire_bytes) if wire_bytes else 0.0,
        "encode": codec_phases.get("compress/encode"),
        "decode": codec_phases.get("compress/decode"),
    }

    # -- client health (health/* gauges, latest snapshot per client) ------
    client_health: Dict[str, Dict[str, float]] = {}
    mem_gauges: Dict[str, float] = {}
    services: Dict[str, float] = {}
    for rec in metrics:
        name = rec.get("name", "")
        labels = rec.get("labels") or {}
        if name in ("health/straggler_score", "health/anomaly_score") and (
                "client" in labels):
            row = client_health.setdefault(str(labels["client"]), {})
            row[name.split("/")[1]] = rec.get("value", 0.0)
        elif name.startswith(("mem/", "quant/")) and (
                rec.get("kind") == "gauge"):
            lbl = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            mem_gauges[name + ("{" + lbl + "}" if lbl else "")] = rec.get(
                "value", 0.0)
        elif name.startswith(("serving/", "scheduler/")):
            # endpoint/job health routed through the registry (not the old
            # private monitor dicts) — latest snapshot per name+labels
            lbl = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
            key = name + ("{" + lbl + "}" if lbl else "")
            if rec.get("kind") == "histogram":
                services[key + ".p95"] = rec.get("p95", 0.0)
                services[key + ".count"] = rec.get("count", 0)
            else:
                services[key] = rec.get("value", 0.0)

    # -- serving token-latency attribution (TTFT / TPOT / decode rate) ----
    # full percentile rows per endpoint ("engine" = the engine's own
    # unlabeled instruments); metrics.jsonl is append-order cumulative
    # snapshots, so plain overwrite keeps the latest record per key
    serving_latency: Dict[str, Dict[str, float]] = {}
    for rec in metrics:
        name = rec.get("name", "")
        if name not in ("serving/ttft_ms", "serving/tpot_ms",
                        "serving/tokens_per_s", "serving/queue_wait_ms"):
            continue
        labels = rec.get("labels") or {}
        row = serving_latency.setdefault(labels.get("endpoint", "engine"), {})
        # "ttft_ms" -> "ttft": percentile keys carry ms already
        key = name.split("/", 1)[1]
        key = key[:-3] if key.endswith("_ms") else key
        if rec.get("kind") == "histogram":
            if not rec.get("count"):
                continue
            for q in ("p50", "p95", "p99"):
                row[f"{key}_{q}"] = rec.get(q, 0.0)
            row[f"{key}_count"] = rec.get("count", 0)
        else:
            row[key] = rec.get("value", 0.0)
    serving_latency = {ep: row for ep, row in serving_latency.items() if row}

    # -- performance attribution (program catalog × phase walls) ----------
    # programs.jsonl names every hot-path program with its flops and bytes
    # (the port's counted ones, or the reference's XLA cost analysis);
    # joining against the measured phase walls yields achieved FLOP/s +
    # bytes/s per phase, a roofline class per program, and the per-round
    # MFU decomposition
    programs = data.programs
    attribution: Dict = {}
    if programs:
        from fedml_tpu_torch.telemetry.profiling.roofline import build_attribution

        attribution = build_attribution(
            phases=phase_rows, rounds=round_rows, programs=programs,
            device_kind=next((p.get("device_kind") for p in programs
                              if p.get("device_kind")), None))
    else:
        notes.setdefault(
            "attribution",
            "no data: programs.jsonl missing (run predates the program "
            "catalog, or profiling was disabled via FEDML_PROFILE=0)")

    # -- stitched (cross-process) spans ----------------------------------
    stitched = [s for s in spans if s.get("remote_parent")]

    # -- causal critical path (per-round assembled-trace walk) ------------
    critical_path: Dict = {}
    if spans:
        try:
            from fedml_tpu_torch.telemetry.tracing import (
                assemble_records,
                compute_critical_paths,
                summarize_critical_paths,
            )

            trace = assemble_records(data.trace_records)
            cps = compute_critical_paths(trace, programs=programs or None)
            if cps:
                critical_path = summarize_critical_paths(cps)
                critical_path["clocks"] = [
                    c.to_dict() for c in sorted(trace.clocks.values(),
                                                key=lambda c: c.node)]
        except Exception as e:  # noqa: BLE001 - the report degrades, never raises
            notes["critical_path"] = f"trace assembly failed: {e!r}"

    return {
        "schema": "fedml_tpu.telemetry.report/v1",
        "run_dir": run_dir,
        "n_spans": len(spans),
        "n_metrics": len(metrics),
        "notes": notes,
        "rounds": round_rows,
        "phases": phase_rows,
        "stragglers": stragglers,
        "stage_overlap": stage_overlap,
        "compile_ms": compile_ms,
        "execute_ms": max(round_total - compile_ms, 0.0),
        "comm_bytes": comm,
        "compression": compression,
        "client_health": client_health,
        "mem_gauges": mem_gauges,
        "services": services,
        "serving_latency": serving_latency,
        "attribution": attribution,
        "critical_path": critical_path,
        "stitched_spans": stitched,
    }


def format_report(report: Dict) -> str:
    lines: List[str] = []
    add = lines.append
    add(f"telemetry report: {report['run_dir']} "
        f"({report['n_spans']} spans)")
    notes = report.get("notes") or {}
    add("")
    add("per-round timeline:")
    if not report["rounds"] and "spans" in notes:
        add(f"  {notes['spans']}")
    for r in report["rounds"]:
        add(f"  round {r['round']}: wall {r['wall_ms']:.1f} ms")
        for phase, total in r["phases"].items():
            add(f"    {phase:<42s} {total:>10.1f} ms")
    add("")
    add("per-phase percentiles (all rounds):")
    add(f"  {'phase':<44s}{'count':>6s}{'p50 ms':>10s}{'p95 ms':>10s}"
        f"{'p99 ms':>10s}")
    for p in report["phases"]:
        add(f"  {p['phase']:<44s}{p['count']:>6d}{p['p50_ms']:>10.1f}"
            f"{p['p95_ms']:>10.1f}{p['p99_ms']:>10.1f}")
    overlap = report.get("stage_overlap") or {}
    if overlap.get("rounds"):
        add("")
        add("stage overlap (prefetched staging vs in-flight round, "
            "chained-timing caveat applies):")
        for r in overlap["rounds"]:
            add(f"  round {r['round']}: prefetch {r['prefetch_ms']:.1f} ms, "
                f"overlapped {r['overlapped_ms']:.1f} ms "
                f"(ratio {r['ratio']:.2f})")
        add(f"  overall overlap ratio: {overlap['ratio']:.2f}")
    if report["compile_ms"]:
        add("")
        add(f"kernel builds vs execute: build {report['compile_ms']:.1f} ms, "
            f"execute {report['execute_ms']:.1f} ms")
    if report["stragglers"]:
        add("")
        add("straggler attribution (slowest client per round):")
        for s in report["stragglers"]:
            add(f"  round {s['round']}: client {s['client']} "
                f"{s['duration_ms']:.1f} ms ({100 * s['share']:.0f}% of "
                "client time)")
    if report["comm_bytes"]:
        add("")
        add("comm bytes breakdown:")
        for name, v in sorted(report["comm_bytes"].items()):
            add(f"  {name:<44s}{v:>14.0f}")
    elif "metrics" in notes:
        add("")
        add(f"comm bytes breakdown: {notes['metrics']}")
    if report.get("client_health"):
        add("")
        add("client health (latest straggler/anomaly scores):")
        for cid, row in sorted(report["client_health"].items()):
            add(f"  client {cid}: straggler "
                f"{row.get('straggler_score', 0.0):.2f}x, anomaly "
                f"{row.get('anomaly_score', 0.0):.2f}")
    if report.get("mem_gauges"):
        add("")
        add("device/host memory (latest sampled gauges):")
        for name, v in sorted(report["mem_gauges"].items()):
            add(f"  {name:<44s}{v:>14.0f}")
    if report.get("services"):
        add("")
        add("service health (serving/scheduler):")
        for name, v in sorted(report["services"].items()):
            add(f"  {name:<44s}{v:>14}")
    if report.get("serving_latency"):
        add("")
        add("serving token latency (TTFT / inter-token / decode rate):")
        for ep, row in sorted(report["serving_latency"].items()):
            add(f"  endpoint {ep}:")
            for kind in ("ttft", "tpot", "queue_wait"):
                if f"{kind}_count" in row:
                    add(f"    {kind + '_ms':<14s} p50 "
                        f"{row.get(kind + '_p50', 0.0):>8.2f}  p95 "
                        f"{row.get(kind + '_p95', 0.0):>8.2f}  p99 "
                        f"{row.get(kind + '_p99', 0.0):>8.2f}  "
                        f"(n={row.get(kind + '_count', 0)})")
            if "tokens_per_s" in row:
                add(f"    {'tokens_per_s':<14s} {row['tokens_per_s']:.2f}")
    comp = report.get("compression") or {}
    if comp.get("raw_bytes") or comp.get("encode") or comp.get("decode"):
        add("")
        add("compression (payload raw bytes vs wire bytes, control-frame "
            "overhead included):")
        if comp.get("raw_bytes"):
            add(f"  raw {comp['raw_bytes']:.0f} B → wire "
                f"{comp['wire_bytes']:.0f} B "
                f"(ratio {comp['ratio']:.2f}x)")
        else:
            add("  in-process run: codec spans only (no transport bytes "
                "recorded)")
        for phase_key in ("encode", "decode"):
            p = comp.get(phase_key)
            if p:
                add(f"  {p['phase']:<24s} count {p['count']:>5d}  "
                    f"p50 {p['p50_ms']:.1f} ms  p95 {p['p95_ms']:.1f} ms  "
                    f"total {p['total_ms']:.1f} ms")
    attr = report.get("attribution") or {}
    if attr.get("programs"):
        add("")
        ridge = attr.get("ridge_flops_per_byte")
        dev = attr.get("device_kind") or "unknown device"
        add(f"performance attribution ({dev}, roofline ridge "
            f"{ridge:.1f} flop/byte):")
        add(f"  {'program':<30s}{'calls':>7s}{'GFLOP':>9s}{'MB acc':>9s}"
            f"{'AI':>8s}{'class':>15s}{'peakHBM':>10s}{'recomp':>7s}")
        for p in attr["programs"][:16]:
            ai = p.get("arithmetic_intensity")
            ai_s = "-" if ai is None else f"{ai:.1f}"
            add(f"  {p['name']:<30s}{p['calls']:>7d}"
                f"{p['flops'] / 1e9:>9.3f}"
                f"{p['bytes_accessed'] / 1e6:>9.2f}"
                f"{ai_s:>8s}"
                f"{p.get('roofline_class') or '-':>15s}"
                f"{p['peak_hbm_bytes'] / 1e6:>9.1f}M"
                f"{p['recompiles']:>7d}")
        phase_attr = [p for p in attr.get("phases") or []
                      if p.get("wall_ms")]
        if phase_attr:
            add("  per-phase achieved rates:")
            for p in phase_attr:
                rate = p.get("achieved_flops_per_s")
                bw = p.get("achieved_bytes_per_s")
                mfu = p.get("mfu")
                line = (f"    {p['phase']:<40s}"
                        f"{(rate or 0) / 1e9:>9.2f} GFLOP/s"
                        f"{(bw or 0) / 1e9:>9.3f} GB/s"
                        f"  {p.get('roofline_class') or '-'}")
                if mfu is not None:
                    line += f"  mfu {mfu:.3f}"
                add(line)
        overall = attr.get("overall") or {}
        if overall.get("achieved_flops_per_s"):
            line = (f"  whole-run: {overall['achieved_flops_per_s'] / 1e9:.2f}"
                    f" GFLOP/s over {overall['round_wall_ms']:.0f} ms of "
                    f"round wall (provenance: {overall.get('provenance')})")
            if overall.get("mfu") is not None:
                line += f", MFU {overall['mfu']:.4f}"
            add(line)
        top = attr.get("top_hbm_program")
        if top:
            add(f"  top peak-HBM consumer: {top['name']} "
                f"({top['peak_hbm_bytes'] / 1e6:.1f} MB live at peak, "
                f"{top.get('roofline_class') or 'class unknown'})")
    elif "attribution" in notes:
        add("")
        add(f"performance attribution: {notes['attribution']}")
    cp = report.get("critical_path") or {}
    if cp.get("rounds"):
        add("")
        add("critical path (per-round longest causal chain, aligned "
            "timeline):")
        for r in cp["rounds"]:
            strag = r.get("straggler") or {}
            extra = ""
            if strag:
                extra = (f"  straggler client {strag['client']} "
                         + ("ON path" if strag.get("on_critical_path")
                            else "has slack")
                         + f", removing saves <= {strag['savings_ms']:.1f} ms")
            add(f"  round {r['round']}: path {r['path_ms']:.1f} ms / wall "
                f"{r['wall_ms']:.1f} ms, top phase {r['top_phase']} "
                f"({100 * (r.get('top_share') or 0):.0f}%)" + extra)
            kinds = r.get("by_kind") or {}
            if kinds:
                add("    " + "  ".join(f"{k} {v:.1f} ms"
                                       for k, v in sorted(kinds.items())))
        clocks = [c for c in cp.get("clocks") or []
                  if c.get("method") not in ("reference", None)]
        if clocks:
            add("  clock alignment:")
            for c in clocks:
                unc = c.get("uncertainty_ms")
                add(f"    node {c['node']}: offset {c['offset_ms']:+.2f} ms "
                    f"+/- {unc if unc is not None else '?'} ms "
                    f"({c['method']}, {c['pairs']} pairs)")
    if report["stitched_spans"]:
        add("")
        add(f"cross-process stitched spans: {len(report['stitched_spans'])}")
        for s in report["stitched_spans"][:10]:
            add(f"  {s['name']} trace={s['trace_id'][:8]} "
                f"parent={s['parent_id']} (publisher-side origin)")
    return "\n".join(lines)
