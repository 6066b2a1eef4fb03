"""In-process aggregation-tree runner — counterpart of
``fedml_tpu/hierarchy/runner.py``: 100k+ virtual clients on one device.

:class:`TreeRunner` drives a whole N-tier federation round by round in one
process: virtual leaf clients draw seeded deltas and upload them compressed
(one batched pass a fixed-size chunk, :func:`~fedml_tpu_torch.hierarchy.
edge.leaf_chunk`), edge aggregators forward partial sums in the compressed
block domain, and the root closes the global round. Chaos (kill windows at
any tier, an interior aggregator crashed and restarted from its journal),
quorum closes, eviction and rejoin are functions of the seed — two runs of
one scenario end bit-identical. The global parameters stay on the run's
device; ``final_digest`` hashes the reference's bytes (the f32 leaves in
its leaf order and layout), copied to the host once at the end.

Telemetry lands per tier under the reference's ``tier/<d>/...`` names
(upload bytes, contributions, quorum closes and failures, evictions,
rejoins, restarts, screened uplinks, nodes and peak buffered bytes); the
trace controller brackets each round (``tree --trace-rounds`` captures
it). Every tier counter's event (eviction, rejoin, restart, screened
uplink, quorum close or failure) is also a tier-tagged ``resilience_event``
record in ``health.jsonl``, and each leaf-parent edge is scored as a client
of a ``ClientHealthTracker`` (its cohort's reduce wall is its round
latency; on the card the reduce's span between two CUDA events, read at the
round's end), so ``telemetry doctor`` triages a tree run's tiers and slow
edges. With ``live=`` (a ``telemetry.live.LivePlane``) the root loops its
registry, the ``tier/<d>/*`` counters and the edges' health scores, into
the plane's collector after every global round, so its ``/metrics`` and
online doctor follow the tree while it runs.
"""
from __future__ import annotations

import hashlib
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.compression.codecs import (
    _is_float_meta,
    _numel,
    _tree_meta,
    derive_key,
    get_codec,
)
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.hierarchy.edge import EdgeAggregator, LeafCohort
from fedml_tpu_torch.hierarchy.partial_sum import PartialSum, compressed_nbytes
from fedml_tpu_torch.hierarchy.tree import TreeTopology
from fedml_tpu_torch.models.convert import flatten_paths
from fedml_tpu_torch.resilience.quorum import quorum_size
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.telemetry.health import ClientHealthTracker, log_health_event
from fedml_tpu_torch.telemetry.profiling import get_trace_controller
from fedml_tpu_torch.utils.tree import Tree, tree_flatten

logger = logging.getLogger(__name__)

__all__ = ["EdgeKillWindow", "KillWindow", "TreeRunner", "default_template",
           "last_dp_trace"]

# key-space offset for tier-aggregator encode keys, so edge re-encode streams
# never collide with leaf-client upload streams
_EDGE_KEY_BASE = 0x40000000
# key id of the root's central-DP noise draw: its own stream
_DP_KEY_ID = 0x60000000

# the central-DP probe, under the reference's keys: the root mean was still a
# tensor on the run's device when the noise landed (never a host array that
# something could log or checkpoint before the noise)
_DP_TRACE: Dict[str, Any] = {"pre_noise_traced": None, "noised_in_program": None}


def last_dp_trace() -> Dict[str, Any]:
    """Snapshot of the central-DP probe."""
    return dict(_DP_TRACE)


class KillWindow:
    """Chaos: node ``node`` at tier ``tier`` is dead for rounds ``[round,
    until)`` (default: one round). At the leaf tier ``node`` is a global
    client index."""

    __slots__ = ("tier", "node", "round", "until")

    def __init__(self, tier: int, node: int, round: int, until: Optional[int] = None):
        self.tier = int(tier)
        self.node = int(node)
        self.round = int(round)
        self.until = int(until) if until is not None else self.round + 1

    def dead_at(self, tier: int, round_idx: int) -> bool:
        return self.tier == tier and self.round <= round_idx < self.until


class EdgeKillWindow:
    """Chaos for the aggregator itself: CRASH the interior aggregator at
    ``(tier, node)`` during round ``round`` after it accepted
    ``after_children`` offers, then restart it from its write-ahead journal
    (needs ``TreeRunner(durability_dir=...)``). The node comes straight back
    and finishes its round with every buffered partial sum: the run ends
    digest-identical to an unkilled one."""

    __slots__ = ("tier", "node", "round", "after_children")

    def __init__(self, tier: int, node: int, round: int, after_children: int = 1):
        self.tier = int(tier)
        self.node = int(node)
        self.round = int(round)
        self.after_children = max(1, int(after_children))


def default_template(n_params: int = 1024) -> Dict[str, np.ndarray]:
    """A small two-leaf f32 model template with ~n_params elements."""
    d = max(2, int(round((int(n_params) * 3 // 4) ** 0.5)))
    k = max(1, (int(n_params) - d) // d)
    return {"w": np.zeros((d, k), np.float32), "b": np.zeros((k,), np.float32)}


def _make_delta_fn(meta) -> Callable[[torch.Tensor], tuple]:
    """Seeded virtual-client deltas: ``0.05 · normal`` per leaf under
    ``fold_in(key, leaf)``, every leaf of every row of the chunk drawn by one
    threefry hash. Takes the chunk's ``[C, 2]`` key data, returns one
    ``[C, *shape]`` tensor a leaf (views of one flat draw)."""
    ids = list(range(len(meta)))
    sizes = [_numel(sh) for _, sh in meta]

    def delta_fn(keys: torch.Tensor) -> tuple:
        flat = 0.05 * threefry.normal_leaves(keys, ids, sizes)
        out, off = [], 0
        for (_, sh), n in zip(meta, sizes):
            out.append(flat[:, off:off + n].reshape((keys.shape[0],) + tuple(sh)))
            off += n
        return tuple(out)

    return delta_fn


def _leaf_tensor(x: Any, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(device).contiguous().clone()
    return torch.from_numpy(np.array(x)).to(device)


class TreeRunner:
    """Run a hierarchical federation on a :class:`TreeTopology`, on ``device``.

    ``template`` is the model tree in the reference's layout (a nested dict
    or a flat ``{path: leaf}`` dict of tensors or arrays, e.g.
    ``models.convert.to_wire_params`` of a model); ``codec`` the wire codec
    at EVERY tier; ``quorum`` the per-cohort close fraction; ``chaos`` a list
    of :class:`KillWindow`, :class:`EdgeKillWindow` and
    ``CorruptUpdateWindow`` (with ``tier``); ``ef=True`` keeps stacked
    per-client error feedback at the leaf tier. ``delta_fn`` replaces the
    virtual clients' update generator: it takes a chunk's ``[C, 2]`` key
    data (an int64 tensor on the device, one client a row) and returns one
    ``[C, *shape]`` tensor a template leaf — the one deliberate difference
    from the reference, whose ``delta_fn`` takes one client's key.
    """

    def __init__(self, topology: TreeTopology, template: Optional[Any] = None,
                 codec: str = "int8", seed: int = 0, quorum: float = 1.0,
                 chunk: int = 2048, ef: bool = False, chaos: Optional[Sequence[Any]] = None,
                 delta_fn: Optional[Callable] = None, server_lr: float = 1.0,
                 on_round: Optional[Callable[[int, Tree], None]] = None,
                 live: Optional[Any] = None, secagg: bool = False,
                 secagg_clip: float = 0.1, secagg_mod_bits: int = 8,
                 dp_sigma: float = 0.0, durability_dir: Optional[str] = None,
                 agg_robust: Optional[str] = None, screen: bool = False,
                 device: DeviceLike = "cuda"):
        from fedml_tpu_torch.resilience.chaos import CorruptUpdateWindow

        self.device = resolve_device(device)
        self.topology = topology
        self.codec = get_codec(codec)
        if self.codec is None:
            raise ValueError("TreeRunner needs a codec; use 'identity' for an "
                             "uncompressed wire")
        self.seed = int(seed)
        self.quorum = float(quorum)
        # update integrity: agg_robust closes EVERY tier's cohort with the
        # fused robust statistic; screen=True screens the partial sums that
        # travel between tiers (a corrupt uplink is refused a tier up)
        self.agg_robust = None
        if agg_robust:
            from fedml_tpu_torch.integrity import parse_robust_spec

            parse_robust_spec(agg_robust)  # validate, fail loudly
            if secagg:
                raise ValueError(
                    "agg_robust cannot run under per-cohort secagg — per-coordinate "
                    "sorting needs the per-client values the masks hide")
            self.agg_robust = str(agg_robust)
        self._screens: Dict[int, Any] = {}
        if screen:
            if secagg:
                raise ValueError("per-tier screening cannot run under secagg (masked "
                                 "partials are opaque by design)")
            from fedml_tpu_torch.integrity import UpdateScreen

            # one screen a tier: leaf-delta norms and cohort-mean norms differ
            self._screens = {d: UpdateScreen() for d in range(topology.n_tiers)}
        self.corrupts = [k for k in (chaos or []) if isinstance(k, CorruptUpdateWindow)]
        self.edge_kills = [k for k in (chaos or []) if isinstance(k, EdgeKillWindow)]
        self.chaos = [k for k in (chaos or [])
                      if not isinstance(k, (EdgeKillWindow, CorruptUpdateWindow))]
        self.durability_dir = durability_dir
        if self.edge_kills and not durability_dir:
            raise ValueError("EdgeKillWindow chaos needs durability_dir — a crashed edge "
                             "can only restart from its write-ahead journal")
        self.server_lr = float(server_lr)
        # central DP at the root: Gaussian noise of std dp_sigma on the global
        # SUM (dp_sigma / total_weight on the mean), from its own stream, added
        # on the device before the mean is applied
        self.dp_sigma = float(dp_sigma)
        self.last_root_weight = 0.0
        template = default_template() if template is None else template
        leaves, self._keys = tree_flatten(flatten_paths(dict(template)))
        self.global_leaves: List[torch.Tensor] = [_leaf_tensor(x, self.device)
                                                  for x in leaves]
        self.meta = _tree_meta(self.global_leaves)
        if not all(_is_float_meta(dt) for dt, _ in self.meta):
            raise ValueError("TreeRunner virtual cohorts support float-leaf templates "
                             "only (int/bool leaves have no mean-delta semantics here)")
        self.delta_fn = delta_fn or _make_delta_fn(self.meta)
        # called with (round_idx, global_params) after every root close; a
        # listener's failure must not corrupt the federation
        self.on_round = on_round
        # the live plane (optional): pumped after every global round
        self.live = live
        self._f32_tree_nbytes = sum(_numel(sh) * 4 for _, sh in self.meta)

        L = topology.leaf_tier
        # leaf cohorts (tier L), owned by the tier L-1 edges. Under
        # per-edge-cohort SecAgg the cohort masks inside itself and the edge
        # only ever sees the unmasked cohort SUM
        self.secagg = bool(secagg)
        self.cohorts: List[LeafCohort] = []
        for e in range(topology.levels[L - 1]):
            cids = topology.children(L - 1, e)
            if self.secagg:
                from fedml_tpu_torch.privacy.secagg.hierarchy import SecAggLeafCohort

                if ef:
                    raise ValueError("secagg tree mode does not support per-client EF")
                self.cohorts.append(SecAggLeafCohort(
                    L, e, cids, self.codec, self.meta, self.delta_fn, self.seed,
                    chunk=chunk, clip=float(secagg_clip), mod_bits=int(secagg_mod_bits),
                    device=self.device))
            else:
                self.cohorts.append(LeafCohort(
                    L, e, cids, self.codec, self.meta, self.delta_fn, self.seed,
                    chunk=chunk, ef=ef, agg_robust=self.agg_robust, device=self.device))
        # interior aggregators for tiers 0..L-2
        self.aggregators: Dict[int, List[EdgeAggregator]] = {}
        for d in range(0, L - 1):
            self.aggregators[d] = [
                EdgeAggregator(d, i, topology.children(d, i).tolist(), self.codec,
                               self.quorum, agg_robust=self.agg_robust, device=self.device)
                for i in range(topology.levels[d])]
        if self.durability_dir:
            # one journal an interior node: buffered partial sums durable at
            # wire size
            from fedml_tpu_torch.resilience.durability import RoundJournal

            for d, aggs in self.aggregators.items():
                for agg in aggs:
                    agg.bind_journal(RoundJournal(
                        f"{self.durability_dir}/edge_t{d}_n{agg.node_id}.journal"))
        # per-client wire bytes, from one encoded template
        ct = self.codec.encode(dict(zip(self._keys, self.global_leaves)),
                               key=derive_key(self.seed, 0, 0), is_delta=True)
        self.per_client_wire_nbytes = compressed_nbytes(ct)
        # each leaf-parent edge is a client of the health tracker: a
        # consistently slow edge surfaces in the doctor as a straggler
        self._health = ClientHealthTracker()
        self.stats: Dict[str, Any] = {}

    # -- chaos + telemetry helpers ----------------------------------------
    def _dead(self, tier: int, round_idx: int) -> set:
        return {kw.node for kw in self.chaos if kw.dead_at(tier, round_idx)}

    def _event(self, event: str, tier: int, counter, n: int = 1, **fields) -> None:
        """One tier event: its ``tier/<d>/*`` counter (registered by the
        caller under a literal name) and a tier-tagged ``resilience_event``
        record in ``health.jsonl``."""
        counter.inc(n)
        try:
            log_health_event({"kind": "resilience_event", "event": event, "tier": tier,
                              **fields})
        except OSError:  # observability never breaks the round
            logger.exception("tier event logging failed")

    def _scalar(self, v: float) -> torch.Tensor:
        # a divisor on the device: CUDA multiplies by the reciprocal of a
        # host scalar, the reference divides
        return torch.tensor(float(v), dtype=torch.float32, device=self.device)

    def _tree(self, leaves: Sequence[torch.Tensor]) -> Tree:
        return dict(zip(self._keys, leaves))

    def _maybe_corrupt(self, tier: int, node: int, round_idx: int, ps: PartialSum,
                       reg) -> PartialSum:
        """CorruptUpdateWindow seam: poison node ``(tier, node)``'s UPLINK
        partial sum for the window."""
        from fedml_tpu_torch.resilience.chaos import corrupt_model_payload

        for w in self.corrupts:
            if w.tier == tier and w.rank == node and w.round <= round_idx < w.until:
                reg.counter("resilience/chaos_injections",
                            labels={"action": "corrupt_update"}).inc()
                ps = PartialSum(corrupt_model_payload(ps.ct, w.mode, w.factor),
                                ps.weight, ps.count)
        return ps

    def _screen_partials(self, tier: int, round_idx: int, partials: Dict[int, PartialSum],
                         reg) -> Dict[int, PartialSum]:
        """Per-tier admission screen (integrity ring 1): a corrupt partial
        sum is refused at the tier ABOVE its producer, which then counts as
        missing for the round."""
        screen = self._screens.get(tier)
        if screen is None:
            return partials
        admitted: Dict[int, PartialSum] = {}
        for node, ps in sorted(partials.items()):
            reason = screen.admit(node, round_idx, ps.ct)
            if reason is not None:
                self._event("upload_screened", tier, reg.counter(f"tier/{tier}/screened"),
                            1, round=round_idx, node=node, reason=reason)
                continue
            admitted[node] = ps
        for node, reason in screen.close_round(round_idx).items():
            if admitted.pop(node, None) is not None:
                self._event("upload_screened", tier, reg.counter(f"tier/{tier}/screened"),
                            1, round=round_idx, node=node, reason=reason)
        return admitted

    def _restart_edge(self, round_idx: int, tier: int, node: int, dead: EdgeAggregator,
                      reg) -> EdgeAggregator:
        """EdgeKillWindow seam: the interior aggregator dies mid-round and a
        fresh one restarts from its journal, every buffered partial sum
        salvaged."""
        fresh = EdgeAggregator(tier, node, list(dead.child_ids), self.codec, self.quorum,
                               agg_robust=self.agg_robust, device=self.device)
        fresh.bind_journal(dead._journal)
        salvaged = fresh.restore_from_journal()
        self.aggregators[tier][node] = fresh
        reg.counter("resilience/restarts").inc()
        reg.counter("resilience/journal_replays").inc()
        reg.counter("resilience/journal_salvaged").inc(salvaged)
        self._event("edge_restarted", tier, reg.counter(f"tier/{tier}/restarts"), 1,
                    round=round_idx, node=node, salvaged=salvaged)
        logger.warning("chaos: tier %d node %d killed and journal-restarted at round %d "
                       "with %d salvaged partial sum(s)", tier, node, round_idx, salvaged)
        return fresh

    # -- the round ---------------------------------------------------------
    def _leaf_round(self, round_idx: int, reg) -> Dict[int, PartialSum]:
        """Reduce every leaf cohort; returns the tier-(L-1) node partials."""
        L = self.topology.leaf_tier
        dead_clients = self._dead(L, round_idx)
        partials: Dict[int, PartialSum] = {}
        upload_bytes = 0
        peak_chunk_bytes = 0
        for e, cohort in enumerate(self.cohorts):
            lo = int(cohort.client_ids[0]) if len(cohort.client_ids) else 0
            # probe/rejoin BEFORE selection: an evicted client alive again
            # readmits (EF rows reset) and re-enters the cohort
            if cohort.evicted_mask.any():
                ev_local = np.nonzero(cohort.evicted_mask)[0]
                alive_again = np.asarray([i for i in ev_local
                                          if (lo + int(i)) not in dead_clients], np.int64)
                back = cohort.readmit(alive_again)
                if len(back):
                    self._event("rejoined", L, reg.counter(f"tier/{L}/rejoined"), len(back),
                                round=round_idx, clients=[int(c) for c in back[:16]])
            alive = np.ones(len(cohort.client_ids), bool)
            for c in dead_clients:
                if 0 <= c - lo < len(alive):
                    alive[c - lo] = False
            expected = cohort.n_expected()
            # the reduce wall is the edge's round latency; on the card it is
            # the reduce's span on the device (CUDA events, read once at the
            # round's end: the host clock would cover only the launches, and
            # a sync an edge would stall the launch queue)
            if self.device.type == "cuda":
                started = torch.cuda.Event(enable_timing=True)
                started.record()
            else:
                started = time.perf_counter()
            sum_leaves, total_w, n_recv = cohort.reduce(round_idx, alive)
            if self.device.type == "cuda":
                ended = torch.cuda.Event(enable_timing=True)
                ended.record()
                self._edge_walls.append((int(e), started, ended))
            else:
                self._health.observe(int(e), round_idx,
                                     latency_s=time.perf_counter() - started)
            dead_local = np.nonzero(~alive & ~cohort.evicted_mask)[0]
            if len(dead_local):
                gone = cohort.evict(dead_local)
                self._event("evicted", L, reg.counter(f"tier/{L}/evicted"), len(gone),
                            round=round_idx, clients=[int(c) for c in gone[:16]])
            if n_recv < quorum_size(max(1, expected), self.quorum) or sum_leaves is None:
                self._event("quorum_failed", L - 1,
                            reg.counter(f"tier/{L - 1}/quorum_failures"), 1,
                            round=round_idx, node=e, received=n_recv, expected=expected)
                continue
            if n_recv < expected:
                self._event("quorum_close", L - 1,
                            reg.counter(f"tier/{L - 1}/quorum_closes"), 1,
                            round=round_idx, node=e, received=n_recv, expected=expected)
            if getattr(cohort, "returns_mean", False):
                mean = sum_leaves  # a robust cohort reduces straight to the statistic
            else:
                w = self._scalar(total_w)
                mean = [s / w for s in sum_leaves]
            key = derive_key(self.seed, round_idx, _EDGE_KEY_BASE + ((L - 1) << 20) + e)
            ct = self.codec.encode(self._tree(mean), key=key, is_delta=True)
            partials[e] = self._maybe_corrupt(L - 1, e, round_idx,
                                              PartialSum(ct, total_w, n_recv), reg)
            upload_bytes += n_recv * self.per_client_wire_nbytes
            peak_chunk_bytes = max(peak_chunk_bytes, min(len(cohort.client_ids), cohort.chunk)
                                   * self.per_client_wire_nbytes)
        reg.counter(f"tier/{L}/upload_bytes").inc(upload_bytes)
        reg.counter(f"tier/{L}/contributions").inc(sum(p.count for p in partials.values()))
        self._tier_round_bytes[L] = upload_bytes
        # leaf-tier buffering is the in-flight chunk of compressed blocks
        self._tier_peak_buffer[L] = max(self._tier_peak_buffer.get(L, 0), peak_chunk_bytes)
        return partials

    def _interior_round(self, round_idx: int, tier: int, child_partials: Dict[int, PartialSum],
                        reg) -> Dict[int, PartialSum]:
        """One interior tier: children's partials → this tier's partials."""
        dead_here = self._dead(tier + 1, round_idx)  # children that died
        # ring 1 at this tier's ingress: corrupt child uplinks are refused
        # before any aggregator buffers them
        child_partials = self._screen_partials(tier + 1, round_idx, child_partials, reg)
        out: Dict[int, PartialSum] = {}
        upload_bytes = 0
        for node, agg in enumerate(self.aggregators[tier]):
            # probe/rejoin before the round opens (same rule as the leaves)
            for c in agg.evicted():
                if c not in dead_here and c in child_partials and agg.readmit(c):
                    self._event("rejoined", tier + 1,
                                reg.counter(f"tier/{tier + 1}/rejoined"), 1,
                                round=round_idx, node=c)
            expected = agg.begin_round(round_idx)
            kill = next((k for k in self.edge_kills
                         if k.tier == tier and k.node == node and k.round == round_idx), None)
            accepted = 0
            for c in expected:
                ps = child_partials.get(c)
                if ps is not None and c not in dead_here:
                    if agg.offer(c, ps):
                        accepted += 1
                    upload_bytes += ps.nbytes
                    if kill is not None and accepted == kill.after_children:
                        agg = self._restart_edge(round_idx, tier, node, agg, reg)
                        kill = None
            received = agg.received()
            key = derive_key(self.seed, round_idx, _EDGE_KEY_BASE + (tier << 20) + node)
            if tier == 0:
                mean, total_w, missing = agg.close_round_root()
                if missing:
                    self._event("evicted", 1, reg.counter("tier/1/evicted"), len(missing),
                                round=round_idx, nodes=missing)
                if mean is None:
                    raise RuntimeError(
                        f"global round {round_idx} below quorum at the root: {received}/"
                        f"{len(expected)} tier-1 partial sums (need "
                        f"{quorum_size(max(1, len(expected)), self.quorum)})")
                if received < len(expected):
                    self._event("quorum_close", 0, reg.counter("tier/0/quorum_closes"), 1,
                                round=round_idx, received=received,
                                expected=len(expected))
                self._root_close = ([mean[k] for k in self._keys], total_w)
            else:
                ps, missing = agg.close_round(key)
                if missing:
                    self._event("evicted", tier + 1, reg.counter(f"tier/{tier + 1}/evicted"),
                                len(missing), round=round_idx, nodes=missing)
                if ps is None:
                    self._event("quorum_failed", tier,
                                reg.counter(f"tier/{tier}/quorum_failures"), 1,
                                round=round_idx, node=node, received=received,
                                expected=len(expected))
                    continue
                if received < len(expected):
                    self._event("quorum_close", tier,
                                reg.counter(f"tier/{tier}/quorum_closes"), 1,
                                round=round_idx, node=node, received=received,
                                expected=len(expected))
                out[node] = self._maybe_corrupt(tier, node, round_idx, ps, reg)
            self._tier_peak_buffer[tier] = max(self._tier_peak_buffer.get(tier, 0),
                                               agg.peak_buffered_nbytes)
        reg.counter(f"tier/{tier + 1}/upload_bytes").inc(upload_bytes)
        self._tier_round_bytes[tier + 1] = max(self._tier_round_bytes.get(tier + 1, 0),
                                               upload_bytes)
        return out

    def run(self, rounds: int) -> Dict[str, Any]:
        """Run ``rounds`` global rounds; returns the scenario result."""
        reg = get_registry()
        topo = self.topology
        L = topo.leaf_tier
        for d in range(L + 1):
            reg.gauge(f"tier/{d}/nodes").set(topo.levels[d])
        self._tier_peak_buffer: Dict[int, int] = {}
        peak_round_bytes: Dict[int, int] = {}
        t0 = time.perf_counter()
        try:
            self._run_rounds(rounds, reg, L, peak_round_bytes)
        finally:
            # a quorum abort mid-round must not leave a trace recording
            get_trace_controller().finish()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0
        for d, v in self._tier_peak_buffer.items():
            reg.gauge(f"tier/{d}/peak_buffer_bytes").set(v)
        per_tier = {str(d): {"nodes": topo.levels[d],
                             "peak_round_upload_bytes": peak_round_bytes.get(d, 0),
                             "peak_buffer_bytes": self._tier_peak_buffer.get(d, 0)}
                    for d in range(L + 1)}
        self.stats = {
            "clients": topo.n_clients,
            "tiers": topo.n_tiers,
            "levels": list(topo.levels),
            "rounds": int(rounds),
            "codec": self.codec.spec,
            "agg_robust": self.agg_robust,
            "secagg": self.secagg,
            "dp_sigma": self.dp_sigma,
            "root_total_weight": self.last_root_weight,
            "seed": self.seed,
            "quorum": self.quorum,
            "wall_s": wall,
            "rounds_per_s": (rounds / wall) if wall > 0 else 0.0,
            "per_client_wire_bytes": self.per_client_wire_nbytes,
            "f32_tree_nbytes": self._f32_tree_nbytes,
            "per_tier": per_tier,
            "final_digest": self.final_digest(),
            "completed": True,
        }
        return self.stats

    def final_digest(self) -> str:
        """blake2b-128 of the global leaves' bytes in the reference's leaf
        order and layout: one copy to the host."""
        flat = torch.cat([x.reshape(-1).view(torch.uint8) for x in self.global_leaves])
        return hashlib.blake2b(flat.cpu().numpy().tobytes(), digest_size=16).hexdigest()

    def _run_rounds(self, rounds: int, reg, L: int, peak_round_bytes: Dict[int, int]) -> None:
        for r in range(int(rounds)):
            # the trace seam: --trace-rounds or a requested capture
            # brackets exactly one tree round
            get_trace_controller().on_round_start(r)
            self._tier_round_bytes: Dict[int, int] = {}
            self._root_close = None
            self._edge_walls: List[tuple] = []
            partials = self._leaf_round(r, reg)
            if L == 1:
                # 2-tier tree: the root IS the single leaf cohort's edge — decode
                # its partial (screened first: the root consumes it)
                partials = self._screen_partials(0, r, partials, reg)
                if 0 not in partials:
                    raise RuntimeError(f"global round {r} below quorum at the root "
                                       "(leaf cohort did not reach quorum)")
                dec = self.codec.decode(partials[0].ct)
                self._root_close = ([dec[k] for k in self._keys], partials[0].weight)
            for tier in range(L - 2, -1, -1):
                partials = self._interior_round(r, tier, partials, reg)
            if self._root_close is None:  # pragma: no cover - defensive
                raise RuntimeError(f"round {r} never reached the root")
            if self._edge_walls:
                self._edge_walls[-1][2].synchronize()
                for e, started, ended in self._edge_walls:
                    self._health.observe(e, r, latency_s=started.elapsed_time(ended) / 1e3)
            self._health.finish_round(r)  # the edges' straggler scoring
            mean, total_w = self._root_close
            self.last_root_weight = float(total_w)
            with torch.no_grad():
                if self.dp_sigma > 0.0:
                    self.global_leaves = self._dp_root_update(r, mean, total_w)
                else:
                    self.global_leaves = [g + (self.server_lr * m).to(g.dtype)
                                          for g, m in zip(self.global_leaves, mean)]
            if self.on_round is not None:
                try:
                    self.on_round(r, self.global_params)
                except Exception:  # a listener must never corrupt training
                    logger.exception("round listener failed at round %d", r)
            if self.live is not None:
                try:
                    self.live.pump(round_idx=r)
                except Exception:  # noqa: BLE001 - observability never corrupts it
                    logger.exception("live telemetry pump failed at round %d", r)
            for d, b in self._tier_round_bytes.items():
                peak_round_bytes[d] = max(peak_round_bytes.get(d, 0), b)
            get_trace_controller().on_round_end(r)

    def _dp_root_update(self, round_idx: int, mean: Sequence[torch.Tensor],
                        total_w: float) -> List[torch.Tensor]:
        """Noise + apply the root mean on the device: the only
        post-aggregation value that can reach the host is the *noised*
        global (the probe records that the pre-noise mean was a tensor on the
        run's device when the noise was added, :func:`last_dp_trace`)."""
        key = derive_key(self.seed, round_idx, _DP_KEY_ID)
        w = self._scalar(total_w)
        out = []
        for i, (g, m) in enumerate(zip(self.global_leaves, mean)):
            _DP_TRACE["pre_noise_traced"] = (isinstance(m, torch.Tensor)
                                             and m.device == g.device)
            noise = self.dp_sigma * threefry.normal(threefry.fold_in(key, i), m.shape,
                                                    self.device)
            out.append(g + self.server_lr * (m + noise / w))
        _DP_TRACE["noised_in_program"] = bool(_DP_TRACE["pre_noise_traced"])
        return out

    @property
    def global_params(self) -> Tree:
        """The global model as a flat ``{path: tensor}`` dict on the device, in
        the template's (the reference's) layout."""
        return self._tree(self.global_leaves)
