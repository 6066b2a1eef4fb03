"""Per-round critical-path extraction and slack attribution (the port's copy
of ``fedml_tpu/telemetry/tracing/critical_path.py``).

Given an assembled trace, walk *backward* from the round's last-finishing
span (normally the server eval) along the chain of causes: into the
latest-finishing same-node child, across ``remote_parent`` stitch points
via the matching ``comm/send`` event (a **wire** edge), up to local
parents, until the chain leaves the round (a parent belonging to an
earlier round) or runs out of causes. Every step emits a segment, and the
segments exactly tile the interval from chain start to round end — so
their durations sum to the measured round wall by construction.

Each segment is attributed: node, phase, span, kind (``compute`` for real
work, ``queue`` for dispatch/handler framing and causal gaps, ``wire``
for cross-process message latency), and — when a program catalog is
available — the dominant cataloged program of its phase.

Slack analysis answers the "so what": per-round client upload arrival
spread gives the what-if saving of removing the straggler (the round can
only close when its last *required* upload lands), and wire share says
whether compression beats rescheduling. A straggler that the quorum or
deadline path already excluded shows up here as "straggler with slack":
slow, but not what bounded the round.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

from fedml_tpu_torch.telemetry.tracing.assemble import AssembledTrace, TraceSpan

_EPS = 1e-6  # seconds; below this a segment is noise, not attribution
_MAX_STEPS = 100_000

# wire segments and causal-gap bridges synthesized by the walk
KIND_COMPUTE = "compute"
KIND_QUEUE = "queue"
KIND_WIRE = "wire"


class Segment:
    """One contiguous slice of the round's critical path."""

    __slots__ = ("node", "span_name", "phase", "kind", "t0", "t1",
                 "client", "program", "flags")

    def __init__(self, node: str, span_name: str, phase: str, kind: str,
                 t0: float, t1: float, client: Optional[str] = None,
                 program: Optional[str] = None,
                 flags: Optional[List[str]] = None):
        self.node = node
        self.span_name = span_name
        self.phase = phase
        self.kind = kind
        self.t0 = t0
        self.t1 = t1
        self.client = client
        self.program = program
        self.flags = flags or []

    @property
    def duration_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3

    def to_dict(self) -> Dict[str, Any]:
        d = {
            "node": self.node, "span": self.span_name, "phase": self.phase,
            "kind": self.kind, "t0": self.t0, "t1": self.t1,
            "duration_ms": round(self.duration_ms, 3),
        }
        if self.client is not None:
            d["client"] = self.client
        if self.program is not None:
            d["program"] = self.program
        if self.flags:
            d["flags"] = list(self.flags)
        return d


def phase_of(name: str) -> str:
    """Collapse a span name to its phase label: the trailing component of
    ``round/<n>[/client/<id>]/<phase>``; ``comm/*`` spans are dispatch
    framing; anything else keeps its own name."""
    if name.startswith("round/"):
        return name.rsplit("/", 1)[-1]
    if name.startswith("comm/"):
        return "dispatch"
    return name


def _kind_of(span: TraceSpan) -> str:
    return KIND_QUEUE if span.name.startswith("comm/") else KIND_COMPUTE


class RoundCriticalPath:
    """The walk result for one round."""

    def __init__(self, round_idx: int, segments: List[Segment],
                 anchor: TraceSpan, wall_ms: float,
                 flags: List[str], straggler: Optional[Dict[str, Any]]):
        self.round = round_idx
        self.segments = segments
        self.anchor = anchor
        self.wall_ms = wall_ms
        self.flags = flags
        self.straggler = straggler

    @property
    def total_ms(self) -> float:
        return sum(s.duration_ms for s in self.segments)

    def by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.segments:
            out[s.kind] = out.get(s.kind, 0.0) + s.duration_ms
        return out

    def by_phase(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.segments:
            out[s.phase] = out.get(s.phase, 0.0) + s.duration_ms
        return out

    def by_node(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for s in self.segments:
            out[s.node] = out.get(s.node, 0.0) + s.duration_ms
        return out

    def top_phase(self) -> Optional[str]:
        phases = self.by_phase()
        if not phases:
            return None
        return max(sorted(phases), key=lambda p: phases[p])

    def top_share(self) -> float:
        phases = self.by_phase()
        total = self.total_ms
        if not phases or total <= 0:
            return 0.0
        return max(phases.values()) / total

    def clients_on_path(self) -> List[str]:
        return sorted({s.client for s in self.segments
                       if s.client is not None})

    def to_dict(self) -> Dict[str, Any]:
        return {
            "round": self.round,
            "wall_ms": round(self.wall_ms, 3),
            "path_ms": round(self.total_ms, 3),
            "coverage": (round(self.total_ms / self.wall_ms, 4)
                         if self.wall_ms > 0 else None),
            "anchor": self.anchor.name,
            "by_kind": {k: round(v, 3) for k, v in self.by_kind().items()},
            "by_phase": {k: round(v, 3)
                         for k, v in sorted(self.by_phase().items())},
            "by_node": {k: round(v, 3) for k, v in self.by_node().items()},
            "top_phase": self.top_phase(),
            "top_share": round(self.top_share(), 4),
            "clients_on_path": self.clients_on_path(),
            "straggler": self.straggler,
            "segments": [s.to_dict() for s in self.segments],
            "flags": list(self.flags),
        }


def _emit(segments: List[Segment], span: TraceSpan, lo: float, hi: float,
          flags: Optional[List[str]] = None) -> None:
    if hi - lo <= _EPS:
        return
    segments.append(Segment(span.node, span.name, phase_of(span.name),
                            _kind_of(span), lo, hi, client=span.client,
                            flags=flags))


def _walk(trace: AssembledTrace, round_idx: int,
          anchor: TraceSpan, round_spans: List[TraceSpan]):
    """Backward walk from ``anchor.t1``; returns (segments, flags) with
    segments in chronological order, exactly tiling the covered interval.
    """
    segments: List[Segment] = []
    flags: List[str] = []
    descended = {anchor.span_id}
    current, t = anchor, anchor.t1
    for _ in range(_MAX_STEPS):
        # 1. descend into the latest same-node child finishing before t —
        # its completion is what unblocked the remainder of `current`
        kids = [k for k in trace.children.get(current.span_id, ())
                if k.node == current.node and k.span_id not in descended
                and k.t1 <= t + _EPS and k.t1 >= current.t0 - _EPS]
        if kids:
            k = max(kids, key=lambda s: s.t1)
            _emit(segments, current, k.t1, t)
            descended.add(k.span_id)
            current, t = k, min(k.t1, t)
            continue
        # 2. nothing left inside: attribute down to the span start
        _emit(segments, current, current.t0, t)
        t = min(t, current.t0)
        # 3. cross the start edge
        if current.remote_parent:
            msg_id = (current.attrs or {}).get("msg_id")
            send_ev = (trace.send_event_for(str(msg_id))
                       if msg_id else None)
            parent = (trace.by_id.get(current.parent_id)
                      if current.parent_id else None)
            if send_ev is not None:
                t_send = min(float(send_ev["t"]), t)
                if t - t_send > _EPS:
                    segments.append(Segment(
                        f"{send_ev['node']}->{current.node}",
                        current.name, "wire", KIND_WIRE, t_send, t))
                t = t_send
                if parent is None:
                    # the send event recorded the sender's open span id
                    sid = send_ev.get("span_id")
                    parent = trace.by_id.get(str(sid)) if sid else None
            else:
                flags.append("unmatched_send:" + current.name)
            if parent is None:
                flags.append("truncated:" + current.name)
                break
            if parent.round is not None and parent.round < round_idx:
                break  # the chain left the round: previous round's work
            current, t = parent, min(t, parent.t1)
            continue
        if current.parent_id:
            parent = trace.by_id.get(current.parent_id)
            if parent is None:
                flags.append("truncated:" + current.name)
                break
            if parent.round is not None and parent.round < round_idx:
                break
            current = parent
            continue
        # 4. root with no parent (loop-style engines emit sibling round
        # spans with no shared ancestor): bridge the causal gap to the
        # latest earlier same-node round span
        cands = [s for s in round_spans
                 if s.node == current.node and s.span_id not in descended
                 and s.t1 <= t + _EPS]
        if not cands:
            break
        k = max(cands, key=lambda s: s.t1)
        if t - k.t1 > _EPS:
            segments.append(Segment(current.node, current.name, "gap",
                                    KIND_QUEUE, k.t1, t))
        descended.add(k.span_id)
        current, t = k, min(k.t1, t)
    segments.reverse()
    return segments, flags


def _round_arrivals(trace: AssembledTrace, round_idx: int
                    ) -> Dict[str, float]:
    """Latest aligned receive time per peer for this round's messages at
    the reference (server) node — the upload-arrival spread."""
    arrivals: Dict[str, float] = {}
    for evs in trace.recvs.values():
        for ev in evs:
            if ev["node"] != trace.ref_node:
                continue
            attrs = ev.get("attrs") or {}
            try:
                ev_round = int(attrs.get("round"))
            except (TypeError, ValueError):
                continue
            if ev_round != round_idx or attrs.get("peer") is None:
                continue
            peer = str(attrs["peer"])
            arrivals[peer] = max(arrivals.get(peer, float("-inf")),
                                 float(ev["t"]))
    return arrivals


def _straggler_analysis(trace: AssembledTrace, round_idx: int,
                        segments: List[Segment]) -> Optional[Dict[str, Any]]:
    arrivals = _round_arrivals(trace, round_idx)
    if len(arrivals) < 2:
        return None
    ordered = sorted(arrivals.items(), key=lambda kv: kv[1])
    worst, worst_t = ordered[-1]
    second_t = ordered[-2][1]
    on_path = {s.client for s in segments if s.client is not None}
    wire_ms = sum(s.duration_ms for s in segments if s.kind == KIND_WIRE)
    return {
        "client": worst,
        "on_critical_path": worst in on_path,
        # the round closes on its last required upload: removing the
        # straggler can save at most the arrival gap to the runner-up
        "savings_ms": round((worst_t - second_t) * 1e3, 3),
        "wire_ms": round(wire_ms, 3),
        "arrivals": len(arrivals),
    }


def compute_critical_path(trace: AssembledTrace, round_idx: int,
                          programs: Optional[List[Dict[str, Any]]] = None
                          ) -> Optional[RoundCriticalPath]:
    """The critical path of one round, or None when the round has no
    spans. ``programs`` (loaded ``programs.jsonl`` records) attaches the
    dominant cataloged program to each compute segment's phase."""
    round_spans = [s for s in trace.rounds.get(round_idx, ())
                   if "/prefetch" not in s.name]
    if not round_spans:
        return None
    anchor = max(round_spans, key=lambda s: s.t1)
    segments, flags = _walk(trace, round_idx, anchor, round_spans)
    wall_ms = (anchor.t1 - min(s.t0 for s in round_spans)) * 1e3
    if programs:
        _attach_programs(segments, programs)
    unaligned = [c.node for c in trace.clocks.values()
                 if c.method == "unaligned"]
    if unaligned and len(trace.clocks) > 1:
        flags.append("unaligned_nodes:" + ",".join(sorted(unaligned)))
    straggler = _straggler_analysis(trace, round_idx, segments)
    return RoundCriticalPath(round_idx, segments, anchor, wall_ms, flags,
                             straggler)


def compute_critical_paths(trace: AssembledTrace,
                           rounds: Optional[List[int]] = None,
                           programs: Optional[List[Dict[str, Any]]] = None
                           ) -> List[RoundCriticalPath]:
    out = []
    for r in (rounds if rounds is not None else trace.round_indexes()):
        cp = compute_critical_path(trace, r, programs=programs)
        if cp is not None:
            out.append(cp)
    return out


def _attach_programs(segments: List[Segment],
                     programs: List[Dict[str, Any]]) -> None:
    """Join the program catalog: each phase's dominant program (most calls
    attributed there) labels that phase's compute segments."""
    from fedml_tpu_torch.telemetry.report import normalize_name

    best: Dict[str, tuple] = {}
    for rec in programs:
        name = rec.get("name")
        for phase, calls in (rec.get("phase_calls") or {}).items():
            calls = int(calls or 0)
            if name and calls > best.get(phase, (0, ""))[0]:
                best[phase] = (calls, str(name))
    for seg in segments:
        if seg.kind != KIND_COMPUTE:
            continue
        hit = best.get(normalize_name(seg.span_name))
        if hit:
            seg.program = hit[1]


def summarize_critical_paths(cps: List[RoundCriticalPath]
                             ) -> Dict[str, Any]:
    """The report/doctor-facing rollup: per-round rows plus whole-run
    kind/phase decomposition."""
    rounds = []
    kind_totals: Dict[str, float] = {}
    phase_totals: Dict[str, float] = {}
    for cp in cps:
        d = cp.to_dict()
        d.pop("segments")  # rows stay table-sized; full detail via trace CLI
        rounds.append(d)
        for k, v in cp.by_kind().items():
            kind_totals[k] = kind_totals.get(k, 0.0) + v
        for k, v in cp.by_phase().items():
            phase_totals[k] = phase_totals.get(k, 0.0) + v
    total = sum(kind_totals.values())
    return {
        "rounds": rounds,
        "by_kind_ms": {k: round(v, 3)
                       for k, v in sorted(kind_totals.items())},
        "by_phase_ms": {k: round(v, 3)
                        for k, v in sorted(phase_totals.items())},
        "total_ms": round(total, 3),
    }
