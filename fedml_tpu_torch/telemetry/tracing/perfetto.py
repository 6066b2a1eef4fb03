"""Perfetto / Chrome trace-event JSON export of an assembled trace (the
port's copy of ``fedml_tpu/telemetry/tracing/perfetto.py``).

Emits the stable subset of the trace-event format both ``ui.perfetto.dev``
and ``chrome://tracing`` load:

- one *process* per federation node (``M``/``process_name`` metadata),
  with spans laid out as complete slices (``ph: "X"``, microsecond
  ``ts``/``dur`` relative to the earliest aligned span start);
- overlapping spans on a node spread across greedy *thread* lanes so
  concurrent handler dispatches render side by side instead of garbled;
- cross-process message edges as flow events (``ph: "s"`` at the send
  point, ``ph: "f", bp: "e"`` binding to the receiving dispatch slice),
  keyed per ``msg_id``;
- optionally, the computed critical path as an extra synthetic process so
  the bounding chain reads as one contiguous track above the real spans.
"""
from __future__ import annotations

import json
import zlib
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.telemetry.tracing.assemble import AssembledTrace, TraceSpan
from fedml_tpu_torch.telemetry.tracing.critical_path import RoundCriticalPath

_CP_PID = 0  # synthetic critical-path track renders above real nodes


def _lanes(spans: List[TraceSpan]) -> Dict[str, int]:
    """Greedy interval-graph coloring: span_id -> lane (tid)."""
    lanes_end: List[float] = []
    assignment: Dict[str, int] = {}
    for s in sorted(spans, key=lambda x: (x.t0, -x.t1)):
        for i, end in enumerate(lanes_end):
            if end <= s.t0 + 1e-9:
                lanes_end[i] = s.t1
                assignment[s.span_id] = i + 1
                break
        else:
            lanes_end.append(s.t1)
            assignment[s.span_id] = len(lanes_end)
    return assignment


def _flow_id(msg_id: str) -> int:
    return zlib.crc32(str(msg_id).encode()) & 0x7FFFFFFF


def export_perfetto(trace: AssembledTrace,
                    critical_paths: Optional[List[RoundCriticalPath]] = None,
                    rounds: Optional[List[int]] = None) -> Dict[str, Any]:
    """Build the trace-event dict (callers json.dump it themselves)."""
    spans = trace.spans
    if rounds is not None:
        keep = set(rounds)
        spans = [s for s in spans if s.round in keep]
    events: List[Dict[str, Any]] = []
    if not spans:
        return {"traceEvents": events, "displayTimeUnit": "ms"}
    base = min(s.t0 for s in spans)

    def us(t: float) -> float:
        return round((t - base) * 1e6, 3)

    pids = {node: i + 1 for i, node in
            enumerate(sorted({s.node for s in spans}))}
    for node, pid in pids.items():
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": f"node:{node}"}})
    by_node: Dict[str, List[TraceSpan]] = {}
    for s in spans:
        by_node.setdefault(s.node, []).append(s)
    lanes: Dict[str, int] = {}
    for node, node_spans in by_node.items():
        lanes.update(_lanes(node_spans))

    for s in spans:
        args: Dict[str, Any] = {"span_id": s.span_id, "node": s.node}
        if s.round is not None:
            args["round"] = s.round
        if s.attrs:
            args.update({k: v for k, v in s.attrs.items()
                         if isinstance(v, (str, int, float, bool))})
        events.append({
            "ph": "X", "name": s.name, "pid": pids[s.node],
            "tid": lanes.get(s.span_id, 1), "ts": us(s.t0),
            "dur": round(s.duration_ms * 1e3, 3), "cat": "span",
            "args": args,
        })

    # message flows: send point -> receiving dispatch slice start
    for msg_id, recvs in trace.recvs.items():
        send = trace.send_event_for(msg_id)
        if send is None:
            continue
        send_node = send["node"]
        sid = str(send.get("span_id") or "")
        send_tid = lanes.get(sid, 1)
        fid = _flow_id(msg_id)
        events.append({"ph": "s", "name": "msg", "cat": "comm", "id": fid,
                       "pid": pids.get(send_node, 1), "tid": send_tid,
                       "ts": us(float(send["t"]))})
        for span in trace.spans:
            if (span.attrs or {}).get("msg_id") == msg_id \
                    and span.remote_parent:
                events.append({"ph": "f", "bp": "e", "name": "msg",
                               "cat": "comm", "id": fid,
                               "pid": pids.get(span.node, 1),
                               "tid": lanes.get(span.span_id, 1),
                               "ts": us(span.t0)})
                break

    if critical_paths:
        events.append({"ph": "M", "name": "process_name", "pid": _CP_PID,
                       "tid": 0, "args": {"name": "critical path"}})
        for cp in critical_paths:
            if rounds is not None and cp.round not in set(rounds):
                continue
            for seg in cp.segments:
                events.append({
                    "ph": "X",
                    "name": f"{seg.phase} [{seg.kind}]",
                    "pid": _CP_PID, "tid": cp.round + 1,
                    "ts": us(seg.t0),
                    "dur": round(seg.duration_ms * 1e3, 3),
                    "cat": "critical-path",
                    "args": {"round": cp.round, "node": seg.node,
                             "span": seg.span_name, "kind": seg.kind},
                })
            events.append({"ph": "M", "name": "thread_name", "pid": _CP_PID,
                           "tid": cp.round + 1,
                           "args": {"name": f"round {cp.round}"}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_perfetto(trace: AssembledTrace, path: str,
                   critical_paths: Optional[List[RoundCriticalPath]] = None,
                   rounds: Optional[List[int]] = None) -> str:
    doc = export_perfetto(trace, critical_paths=critical_paths,
                          rounds=rounds)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path
