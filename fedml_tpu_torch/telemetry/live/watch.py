"""``python -m fedml_tpu_torch.cli telemetry watch`` — a refreshing per-node
terminal view (the port's copy of ``fedml_tpu/telemetry/live/watch.py``;
its text is the reference's, line for line).

Renders the live plane's state as a compact per-round/per-node table: one
row per streaming node (round, clients reporting, worst straggler,
memory, wire bytes, serving round, seq gaps), followed by the online
doctor's most recent alerts. Two targets:

- a scrape endpoint URL (``http://host:port``) — the live path: fetches
  ``/metrics.json`` each refresh;
- a run dir — the offline fallback: reconstructs the same view from the
  latest ``telemetry.jsonl`` registry snapshots (no node attribution
  beyond what labels carry), so the command also works post-hoc.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

__all__ = ["fetch_state", "render_state", "watch"]


def _fetch_url(url: str, timeout: float = 5.0) -> Dict[str, Any]:
    from urllib.request import urlopen

    base = url.rstrip("/")
    if not base.endswith("/metrics.json"):
        base += "/metrics.json"
    with urlopen(base, timeout=timeout) as resp:
        return json.loads(resp.read())


def _state_from_run_dir(run_dir: str) -> Dict[str, Any]:
    """Offline view: latest registry record per (name, labels) + alerts."""
    from fedml_tpu_torch.telemetry.report import load_metrics

    latest: Dict[tuple, Dict] = {}
    alerts: List[Dict] = []
    for rec in load_metrics(run_dir):
        if rec.get("kind") == "doctor_alert":
            alerts.append(rec)
            continue
        name = rec.get("name")
        if not name:
            continue
        key = (name, tuple(sorted((rec.get("labels") or {}).items())))
        latest[key] = rec
    metrics = list(latest.values())
    nodes = sorted({(rec.get("labels") or {}).get("node", "local")
                    for rec in metrics}) or ["local"]
    return {
        "job": os.path.basename(run_dir.rstrip("/")),
        "nodes": len(nodes),
        "frames": 0,
        "seq_gaps": 0,
        "nodes_detail": {n: {"seq": None, "seq_gaps": 0, "last_ts": None}
                         for n in nodes},
        "metrics": metrics,
        "alerts": alerts[-32:],
        "offline": True,
    }


def fetch_state(target: str) -> Dict[str, Any]:
    if target.startswith(("http://", "https://")):
        return _fetch_url(target)
    return _state_from_run_dir(target)


def _fmt_bytes(b: Optional[float]) -> str:
    if not b:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(b) < 1024 or unit == "GiB":
            return f"{b:.0f}{unit}" if unit == "B" else f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}GiB"  # pragma: no cover


def _node_rows(state: Dict[str, Any]) -> List[Dict[str, Any]]:
    by_node: Dict[str, Dict[str, Any]] = {}
    for rec in state.get("metrics") or []:
        labels = rec.get("labels") or {}
        node = labels.get("node", "local")
        row = by_node.setdefault(node, {
            "node": node, "round": None, "clients": None,
            "straggler": None, "straggler_client": None,
            "mem_bytes": None, "wire_bytes": 0.0, "serving_round": None,
            "mfu": None, "hbm_bound": None,
            "critical_phase": None, "critical_share": None,
            "ttft_p95": None, "occupancy": None, "queue_depth": None})
        name = rec.get("name", "")
        val = float(rec.get("value", rec.get("count", 0)) or 0)
        if name == "health/rounds_scored" and val:
            row["round"] = int(val) - 1
        elif name == "health/clients_reporting":
            row["clients"] = int(val)
        elif name == "health/straggler_score":
            if row["straggler"] is None or val > row["straggler"]:
                row["straggler"] = val
                row["straggler_client"] = labels.get("client")
        elif name in ("mem/device_bytes_in_use", "mem/live_buffer_bytes"):
            row["mem_bytes"] = max(row["mem_bytes"] or 0.0, val)
        elif name in ("comm/wire_bytes_out", "comm/offload_wire_bytes"):
            row["wire_bytes"] += val
        elif name == "serving/round_current":
            row["serving_round"] = int(val)
        elif name == "serving/ttft_ms":
            # histogram record: the p95 is the fleet-ready latency column
            if rec.get("count"):
                row["ttft_p95"] = float(rec.get("p95") or 0.0)
        elif name == "serving/batch_occupancy":
            row["occupancy"] = val
        elif name == "serving/queue_depth":
            row["queue_depth"] = val
        elif name == "profile/mfu":
            # streamed by the program catalog's gauge pump: achieved
            # FLOP/s over the device peak, refreshed each phase sample
            row["mfu"] = val
        elif name == "profile/hbm_bound":
            row["hbm_bound"] = bool(val)
        elif name == "tracepath/critical_phase":
            # phase_code()-encoded top phase of the latest round's
            # critical path, pumped by the live plane each round
            row["critical_phase"] = int(val)
        elif name == "tracepath/critical_share":
            row["critical_share"] = val
    detail = state.get("nodes_detail") or {}
    for node, d in detail.items():
        row = by_node.setdefault(node, {
            "node": node, "round": None, "clients": None, "straggler": None,
            "straggler_client": None, "mem_bytes": None, "wire_bytes": 0.0,
            "serving_round": None, "mfu": None, "hbm_bound": None,
            "critical_phase": None, "critical_share": None,
            "ttft_p95": None, "occupancy": None, "queue_depth": None})
        row["seq"] = d.get("seq")
        row["seq_gaps"] = d.get("seq_gaps", 0)
    return [by_node[n] for n in sorted(by_node)]


def render_state(state: Dict[str, Any], now: Optional[float] = None) -> str:
    now = now or time.time()
    lines: List[str] = []
    add = lines.append
    head = (f"live telemetry — job {state.get('job')!s}: "
            f"{state.get('nodes', 0)} node(s), "
            f"{state.get('frames', 0)} frame(s), "
            f"{state.get('seq_gaps', 0)} seq gap(s)")
    if state.get("offline"):
        head += "  [offline: rendered from run-dir snapshots]"
    add(head)
    add("")
    add(f"  {'node':<14s}{'round':>6s}{'clients':>8s}{'straggler':>12s}"
        f"{'mem':>10s}{'wire':>10s}{'mfu':>7s}{'roofline':>10s}"
        f"{'critical':>16s}{'serving':>8s}{'ttft':>9s}{'sat':>9s}"
        f"{'gaps':>6s}")
    for row in _node_rows(state):
        strag = ("-" if row.get("straggler") is None else
                 f"{row['straggler']:.1f}x"
                 + (f"@{row['straggler_client']}"
                    if row.get("straggler_client") else ""))
        mfu = ("-" if row.get("mfu") is None
               else f"{row['mfu']:.2f}")
        roofline = ("-" if row.get("hbm_bound") is None
                    else ("HBM" if row["hbm_bound"] else "compute"))
        if row.get("critical_phase") is None:
            critical = "-"
        else:
            from fedml_tpu_torch.telemetry.tracing import phase_label

            critical = phase_label(row["critical_phase"])
            if row.get("critical_share") is not None:
                critical += f" {100 * row['critical_share']:.0f}%"
        ttft = ("-" if row.get("ttft_p95") is None
                else f"{row['ttft_p95']:.0f}ms")
        # saturation: batch-slot occupancy fraction / admission queue depth
        sat = ("-" if row.get("occupancy") is None
               else f"{100 * row['occupancy']:.0f}%"
               + (f"+{row['queue_depth']:.0f}q"
                  if row.get("queue_depth") else ""))
        add(f"  {row['node']:<14s}"
            f"{row['round'] if row['round'] is not None else '-':>6}"
            f"{row['clients'] if row['clients'] is not None else '-':>8}"
            f"{strag:>12s}"
            f"{_fmt_bytes(row.get('mem_bytes')):>10s}"
            f"{_fmt_bytes(row.get('wire_bytes')):>10s}"
            f"{mfu:>7s}"
            f"{roofline:>10s}"
            f"{critical:>16s}"
            f"{row['serving_round'] if row['serving_round'] is not None else '-':>8}"
            f"{ttft:>9s}"
            f"{sat:>9s}"
            f"{row.get('seq_gaps', 0):>6}")
    alerts = state.get("alerts") or []
    add("")
    if alerts:
        shown = min(len(alerts), 8)
        add(f"alerts (last {shown} of {len(alerts)}, newest last):")
        for a in alerts[-8:]:
            rnd = a.get("round")
            add(f"  [{a.get('rule')}] round {rnd if rnd is not None else '?'}"
                f": {a.get('verdict')}")
    else:
        add("alerts: none")
    return "\n".join(lines)


def watch(target: str, interval_s: float = 2.0, once: bool = False,
          out=None, max_refreshes: Optional[int] = None) -> int:
    """Render the target's live state; refresh every ``interval_s`` until
    interrupted (``once=True`` prints a single frame and exits — the CI
    smoke path). Returns 0, or 1 when the target is unreachable."""
    import sys

    write = out or (lambda s: (sys.stdout.write(s + "\n"),
                               sys.stdout.flush()))
    n = 0
    while True:
        try:
            state = fetch_state(target)
        except (OSError, ValueError) as e:
            write(f"telemetry watch: cannot read {target}: {e}")
            return 1
        text = render_state(state)
        if once or max_refreshes is not None:
            write(text)
        else:  # pragma: no cover - interactive path
            write("\x1b[2J\x1b[H" + text)
        n += 1
        if once or (max_refreshes is not None and n >= max_refreshes):
            return 0
        try:  # pragma: no cover - interactive path
            time.sleep(interval_s)
        except KeyboardInterrupt:  # pragma: no cover
            return 0
