"""Federation-wide trace assembly: every node's spans on one timeline (the
port's copy of ``fedml_tpu/telemetry/tracing/assemble.py``).

Each process lands its own span stream (``spans.jsonl``, plus the point
events ``Tracer.event`` emits into the same sink); distributed runs
additionally ship span-batch frames over the live plane, which the
collector persists node-annotated as ``spans_remote.jsonl``. Assembly:

1. load + normalize records from both sinks (a record's node identity is
   its ``node`` stamp, else its ``service``, else ``"local"``);
2. align clocks: match ``comm/send``/``comm/recv`` point events by
   ``msg_id`` across nodes and run the NTP-style minimum-RTT estimator
   (:mod:`.clock`), anchored at the reference node (the one that runs
   ``round/<n>/aggregate`` — the server);
3. place every span on the aligned timeline (``t0``/``t1`` in reference
   wall seconds) and index it: by span id, by parent (causal children),
   by round, plus send/recv event indexes by ``msg_id``.

The result is the happens-before-ordered round timeline the critical-path
engine (:mod:`.critical_path`) walks and the Perfetto exporter
(:mod:`.perfetto`) renders.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.telemetry.tracing.clock import NodeClock, align_clocks

_ROUND_RE = re.compile(r"^round/(\d+)(?:/|$)")
_CLIENT_RE = re.compile(r"^round/\d+/client/([^/]+)/")

REMOTE_SPANS_FILENAME = "spans_remote.jsonl"


def _record_node(rec: Dict[str, Any]) -> str:
    return str(rec.get("node") or rec.get("service") or "local")


class TraceSpan:
    """One completed span, normalized and placed on the aligned timeline."""

    __slots__ = ("name", "trace_id", "span_id", "parent_id", "node",
                 "started", "ended", "duration_ms", "remote_parent",
                 "attrs", "compile_ms", "round", "client", "t0", "t1",
                 "has_mono")

    def __init__(self, rec: Dict[str, Any]):
        self.name = str(rec.get("name", ""))
        self.trace_id = str(rec.get("trace_id", ""))
        self.span_id = str(rec.get("span_id", ""))
        pid = rec.get("parent_id")
        self.parent_id = str(pid) if pid else None
        self.node = _record_node(rec)
        self.started = float(rec.get("started", 0.0))
        self.duration_ms = float(rec.get("duration_ms", 0.0))
        self.ended = float(rec.get("ended",
                                   self.started + self.duration_ms / 1e3))
        self.remote_parent = bool(rec.get("remote_parent"))
        self.attrs = rec.get("attrs") or {}
        self.compile_ms = float(rec.get("compile_ms", 0.0))
        # pre-monotonic records (old sinks) degrade to wall-clock
        # durations — flagged so consumers can widen their uncertainty
        self.has_mono = "mono" in rec
        m = _ROUND_RE.match(self.name)
        if m:
            self.round: Optional[int] = int(m.group(1))
        elif "round" in self.attrs:
            try:
                self.round = int(self.attrs["round"])
            except (TypeError, ValueError):
                self.round = None
        else:
            self.round = None
        cm = _CLIENT_RE.match(self.name)
        self.client = cm.group(1) if cm else None
        self.t0 = self.started  # re-aligned by assemble_records
        self.t1 = self.ended

    def align(self, clock: NodeClock) -> None:
        self.t0 = clock.align(self.started)
        self.t1 = self.t0 + self.duration_ms / 1e3

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name, "node": self.node, "span_id": self.span_id,
            "parent_id": self.parent_id, "round": self.round,
            "t0": self.t0, "t1": self.t1, "duration_ms": self.duration_ms,
            "remote_parent": self.remote_parent, "attrs": self.attrs,
        }


class AssembledTrace:
    """All nodes' spans and events, aligned and indexed."""

    def __init__(self, spans: List[TraceSpan], events: List[Dict[str, Any]],
                 clocks: Dict[str, NodeClock], ref_node: str):
        self.spans = spans
        self.events = events
        self.clocks = clocks
        self.ref_node = ref_node
        self.by_id: Dict[str, TraceSpan] = {}
        self.children: Dict[str, List[TraceSpan]] = {}
        self.rounds: Dict[int, List[TraceSpan]] = {}
        for s in spans:
            if s.span_id:
                self.by_id[s.span_id] = s
            if s.parent_id:
                self.children.setdefault(s.parent_id, []).append(s)
            if s.round is not None:
                self.rounds.setdefault(s.round, []).append(s)
        # send/recv point events by msg_id, each annotated with the
        # ALIGNED timestamp in ``t`` (raw wall stays in ``ts``)
        self.sends: Dict[str, List[Dict[str, Any]]] = {}
        self.recvs: Dict[str, List[Dict[str, Any]]] = {}
        for ev in events:
            msg_id = (ev.get("attrs") or {}).get("msg_id")
            if not msg_id:
                continue
            clock = clocks.get(ev["node"])
            ev["t"] = (clock.align(ev["ts"]) if clock is not None
                       else ev["ts"])
            if ev["name"] == "comm/send":
                self.sends.setdefault(str(msg_id), []).append(ev)
            elif ev["name"] == "comm/recv":
                self.recvs.setdefault(str(msg_id), []).append(ev)

    @property
    def nodes(self) -> List[str]:
        return sorted({s.node for s in self.spans}
                      | {e["node"] for e in self.events})

    def round_indexes(self) -> List[int]:
        return sorted(self.rounds)

    def send_event_for(self, msg_id: str,
                       node: Optional[str] = None) -> Optional[Dict]:
        """The matching send event for a message (optionally pinned to the
        expected sender node); earliest aligned time wins on duplicates
        (chaos copies share the msg_id on purpose)."""
        cands = self.sends.get(str(msg_id)) or []
        if node is not None:
            pinned = [e for e in cands if e["node"] == node]
            cands = pinned or cands
        return min(cands, key=lambda e: e["t"]) if cands else None


def _pick_reference_node(spans: List[TraceSpan],
                         events: List[Dict[str, Any]]) -> str:
    """The aggregation node is the natural timeline anchor: it opens and
    closes every round. Fallbacks: the node with the most spans, then
    ``"local"``."""
    agg_counts: Dict[str, int] = {}
    span_counts: Dict[str, int] = {}
    for s in spans:
        span_counts[s.node] = span_counts.get(s.node, 0) + 1
        if s.round is not None and s.name.endswith("/aggregate"):
            agg_counts[s.node] = agg_counts.get(s.node, 0) + 1
    for counts in (agg_counts, span_counts):
        if counts:
            return max(sorted(counts), key=lambda n: counts[n])
    if events:
        return _record_node(events[0])
    return "local"


def assemble_records(records: List[Dict[str, Any]]) -> AssembledTrace:
    """Assemble raw span/event record dicts (already node-stamped or
    single-node) into one aligned, indexed trace."""
    spans: List[TraceSpan] = []
    events: List[Dict[str, Any]] = []
    seen_spans = set()
    for rec in records:
        if not isinstance(rec, dict) or "name" not in rec:
            continue
        if rec.get("point"):
            events.append({
                "name": str(rec["name"]),
                "node": _record_node(rec),
                "ts": float(rec.get("ts", 0.0)),
                "attrs": rec.get("attrs") or {},
                "trace_id": rec.get("trace_id"),
                "span_id": rec.get("span_id"),
            })
        elif "duration_ms" in rec:
            span = TraceSpan(rec)
            # the same span can arrive twice (local sink + streamed
            # frame); last writer wins is irrelevant — they're identical
            key = (span.span_id, span.name)
            if span.span_id and key in seen_spans:
                continue
            seen_spans.add(key)
            spans.append(span)
    ref_node = _pick_reference_node(spans, events)

    send_idx: Dict[str, List[dict]] = {}
    recv_idx: Dict[str, List[dict]] = {}
    for ev in events:
        msg_id = (ev.get("attrs") or {}).get("msg_id")
        if not msg_id:
            continue
        if ev["name"] == "comm/send":
            send_idx.setdefault(str(msg_id), []).append(ev)
        elif ev["name"] == "comm/recv":
            recv_idx.setdefault(str(msg_id), []).append(ev)
    clocks = align_clocks(send_idx, recv_idx, ref_node)
    for s in spans:
        clock = clocks.get(s.node)
        if clock is None:
            clock = clocks.setdefault(s.node, NodeClock(s.node))
        s.align(clock)
    spans.sort(key=lambda s: s.t0)
    return AssembledTrace(spans, events, clocks, ref_node)


def load_trace_records(run_dir: str) -> List[Dict[str, Any]]:
    """Raw span + point-event records from a run dir: the local sink plus
    the live-plane-collected remote sink (node-annotated)."""
    from fedml_tpu_torch.telemetry.report import _load_jsonl

    records = _load_jsonl(os.path.join(run_dir, "spans.jsonl"))
    records += _load_jsonl(os.path.join(run_dir, REMOTE_SPANS_FILENAME))
    return records


def assemble_trace(run_dir: str) -> AssembledTrace:
    """Post-hoc assembly from a run dir's sinks."""
    return assemble_records(load_trace_records(run_dir))
