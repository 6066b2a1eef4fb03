"""NTP-style clock alignment from matched comm send/recv pairs (the port's
copy of ``fedml_tpu/telemetry/tracing/clock.py``).

Every node stamps its span and event records with its own ``time.time()``
wall clock; nothing guarantees those clocks agree. But every comm message
gives us a one-way delay sample: the publisher records a ``comm/send``
point event and the subscriber a ``comm/recv`` point event for the same
``msg_id``. Taking the *minimum* observed delay in each direction filters
queueing noise (the classic NTP minimum-filter), leaving::

    d_fwd = min(recv_X - send_ref)  ~=  L_min + theta
    d_rev = min(recv_ref - send_X)  ~=  L_min - theta

where ``theta`` is node X's clock offset relative to the reference node
and ``L_min`` the (assumed symmetric) minimum one-way latency. Hence::

    theta       = (d_fwd - d_rev) / 2
    uncertainty = (d_fwd + d_rev) / 2     (= L_min, an upper bound on the
                                           asymmetry error)

A node seen in only one direction degrades to ``one_way`` alignment
(offset = the one-way delay, uncertainty = its magnitude); a node with no
matched pairs at all stays ``unaligned`` (offset 0, uncertainty None) —
consumers must treat its placement as wall-clock faith.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional


class NodeClock:
    """Offset of one node's wall clock relative to the reference node.

    ``aligned_time = wall_time - offset_s`` places this node's records on
    the reference timeline, within ``+/- uncertainty_s``.
    """

    __slots__ = ("node", "offset_s", "uncertainty_s", "method", "pairs")

    def __init__(self, node: str, offset_s: float = 0.0,
                 uncertainty_s: Optional[float] = None,
                 method: str = "unaligned", pairs: int = 0):
        self.node = node
        self.offset_s = offset_s
        self.uncertainty_s = uncertainty_s
        self.method = method
        self.pairs = pairs

    def align(self, wall_ts: float) -> float:
        return wall_ts - self.offset_s

    def to_dict(self) -> Dict[str, Any]:
        return {
            "node": self.node,
            "offset_ms": round(self.offset_s * 1e3, 3),
            "uncertainty_ms": (round(self.uncertainty_s * 1e3, 3)
                               if self.uncertainty_s is not None else None),
            "method": self.method,
            "pairs": self.pairs,
        }


def _min_delay(samples: List[float]) -> Optional[float]:
    return min(samples) if samples else None


def align_clocks(send_events: Dict[str, List[dict]],
                 recv_events: Dict[str, List[dict]],
                 ref_node: str) -> Dict[str, "NodeClock"]:
    """Estimate per-node clock offsets against ``ref_node``.

    ``send_events`` / ``recv_events`` map ``msg_id -> [event dicts]``
    where each event carries ``node`` and ``ts`` (sender wall clock /
    receiver wall clock). Returns a ``NodeClock`` for every node seen in
    either stream; the reference node gets offset 0 / uncertainty 0.
    """
    # direction samples per non-reference node
    fwd: Dict[str, List[float]] = {}  # ref sent -> node received
    rev: Dict[str, List[float]] = {}  # node sent -> ref received
    nodes = set()
    for msg_id, sends in send_events.items():
        recvs = recv_events.get(msg_id) or []
        for s in sends:
            nodes.add(s["node"])
            for r in recvs:
                nodes.add(r["node"])
                delay = float(r["ts"]) - float(s["ts"])
                if s["node"] == ref_node and r["node"] != ref_node:
                    fwd.setdefault(r["node"], []).append(delay)
                elif s["node"] != ref_node and r["node"] == ref_node:
                    rev.setdefault(s["node"], []).append(delay)
    for recvs in recv_events.values():
        for r in recvs:
            nodes.add(r["node"])

    clocks: Dict[str, NodeClock] = {
        ref_node: NodeClock(ref_node, 0.0, 0.0, "reference")
    }
    for node in sorted(nodes):
        if node == ref_node:
            continue
        d_fwd = _min_delay(fwd.get(node, []))
        d_rev = _min_delay(rev.get(node, []))
        n_pairs = len(fwd.get(node, [])) + len(rev.get(node, []))
        if d_fwd is not None and d_rev is not None:
            theta = (d_fwd - d_rev) / 2.0
            unc = max((d_fwd + d_rev) / 2.0, 0.0)
            clocks[node] = NodeClock(node, theta, unc, "paired", n_pairs)
        elif d_fwd is not None:
            clocks[node] = NodeClock(node, d_fwd, abs(d_fwd), "one_way",
                                     n_pairs)
        elif d_rev is not None:
            clocks[node] = NodeClock(node, -d_rev, abs(d_rev), "one_way",
                                     n_pairs)
        else:
            clocks[node] = NodeClock(node)
    return clocks
