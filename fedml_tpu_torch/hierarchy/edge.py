"""Tier nodes: edge aggregators and batched virtual leaf cohorts —
counterpart of ``fedml_tpu/hierarchy/edge.py``.

- :class:`EdgeAggregator` — an interior node. It buffers its children's
  :class:`~fedml_tpu_torch.hierarchy.partial_sum.PartialSum` uploads for
  the round (compressed blocks only, never N f32 trees), closes on
  all-received or on quorum (``quorum_size`` + ``RoundDeadline``), evicts
  the children that missed the close and readmits them on their next sign
  of life. Bound to a :class:`~fedml_tpu_torch.resilience.durability.
  RoundJournal`, a killed edge re-enters its open round with its buffer.

- :class:`LeafCohort` — the bottom tier of the in-process tree: one edge's
  virtual leaf clients, reduced in fixed-size padded chunks. A chunk is one
  batched pass on the device (:func:`leaf_chunk`, the counterpart of the
  reference's ``jax.vmap`` program): the chunk's ``[C, *shape]`` deltas
  are drawn by one threefry hash, error feedback added, every row encoded
  with one more hash, and the weighted rows summed in a fixed pairwise
  order — no per-client Python loop. Dead and padded slots are masked to
  weight 0 in the same pass, so a chaos kill changes inputs, not shapes.
"""
from __future__ import annotations

import logging
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.compression.codecs import (
    Codec,
    _dtype_from_str,
    _is_float_meta,
    _raw_weighted_sum,
    derive_key_data_batch,
    ordered_row_sum,
)
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.hierarchy.partial_sum import PartialSum, finalize_root, reduce_cohort
from fedml_tpu_torch.resilience.quorum import RoundDeadline, quorum_size
from fedml_tpu_torch.utils.tree import Tree

logger = logging.getLogger(__name__)

# ``delta_fn(keys)``: the chunk's ``[C, 2]`` key data (int64 tensor on the
# device) → one ``[C, *shape]`` tensor a template leaf, in leaf order
DeltaFn = Callable[[torch.Tensor], Sequence[torch.Tensor]]

__all__ = ["EdgeAggregator", "LeafCohort", "leaf_chunk"]


def _next_pow2(n: int) -> int:
    return 1 << max(0, int(n) - 1).bit_length()


class EdgeAggregator:
    """One interior tree node: per-round buffer + quorum close + dropout.

    The buffer holds (child_id → PartialSum) for the current round only;
    ``buffered_nbytes`` is what the peak-memory gauge reads — compressed
    blocks, by construction. ``device`` is where a journal replay puts the
    salvaged partial sums.
    """

    def __init__(self, tier: int, node_id: int, child_ids: Sequence[int], codec: Codec,
                 quorum_frac: float = 1.0, agg_robust: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        self.tier = int(tier)
        self.node_id = int(node_id)
        self.child_ids = [int(c) for c in child_ids]
        self.codec = codec
        self.quorum_frac = float(quorum_frac)
        # Byzantine-robust tier reduction (integrity ring 2)
        self.agg_robust = str(agg_robust) if agg_robust else None
        self.device = resolve_device(device)
        self._evicted: set = set()
        self._buffer: Dict[int, PartialSum] = {}
        self._round: Optional[int] = None
        self._deadline = RoundDeadline(self._on_deadline)
        self._on_expire: Optional[Callable[[int], None]] = None
        self._buffered_nbytes = 0  # running sum: offer is O(1), not O(C)
        self.peak_buffered_nbytes = 0
        self._journal = None  # crash durability, opt-in via bind_journal

    # -- crash durability --------------------------------------------------
    def bind_journal(self, journal) -> None:
        """Opt this edge into the write-ahead journal: round opens and
        accepted offers (the compressed partial sums, wire-sized) become
        durable, so a killed edge re-enters its open round with the buffer
        intact (:meth:`restore_from_journal`)."""
        self._journal = journal

    def restore_from_journal(self) -> int:
        """Rehydrate the open (un-closed) journaled round onto this edge's
        device; returns the number of salvaged child partial sums (0 =
        nothing open)."""
        if self._journal is None:
            return 0
        from fedml_tpu_torch.resilience.durability.journal import scan_open_round

        # the shared replay state machine; an edge's terminal record is its
        # round_closed (the uplink partial is the parent's problem)
        open_rec, uploads, _ = scan_open_round(
            self._journal.records(device=self.device), terminal_kinds=("round_closed",),
            note_kinds=())
        if open_rec is None:
            return 0
        offers = {int(rec["child"]): PartialSum(rec["ct"], float(rec["weight"]),
                                                int(rec["count"]))
                  for rec in uploads}
        self._round = int(open_rec["round"])
        # pre-crash evictions are implied by the journaled expectation
        expected = {int(c) for c in open_rec.get("expected") or []}
        self._evicted = {c for c in self.child_ids if c not in expected}
        self._buffer = {}
        self._buffered_nbytes = 0
        for child, ps in offers.items():
            self._buffer[child] = ps
            self._buffered_nbytes += ps.nbytes
        self.peak_buffered_nbytes = max(self.peak_buffered_nbytes, self._buffered_nbytes)
        return len(offers)

    # -- round lifecycle ---------------------------------------------------
    def begin_round(self, round_idx: int) -> List[int]:
        """Open the round; returns the expected (non-evicted) children."""
        self._round = int(round_idx)
        self._buffer = {}
        self._buffered_nbytes = 0
        expected = self.expected()
        if self._journal is not None:
            self._journal.append("round_open", round=self._round,
                                 expected=[int(c) for c in expected])
        return expected

    def expected(self) -> List[int]:
        return [c for c in self.child_ids if c not in self._evicted]

    def arm_deadline(self, timeout_s: float, on_expire: Callable[[int], None]) -> None:
        """Arm this cohort's round deadline (the callback runs on the timer
        thread with the armed round)."""
        self._on_expire = on_expire
        self._deadline.arm(int(self._round or 0), timeout_s)

    def _on_deadline(self, round_idx: int) -> None:
        if self._on_expire is not None:
            self._on_expire(round_idx)

    def offer(self, child_id: int, ps: PartialSum) -> bool:
        """A child's upload for the open round. False (stale) for unknown
        children, closed rounds, evicted children (an evicted child's upload
        is its sign of life: the caller readmits it for the NEXT round) and
        duplicates."""
        child_id = int(child_id)
        if self._round is None or child_id not in self.child_ids:
            return False
        if child_id in self._evicted or child_id in self._buffer:
            return False
        if self._journal is not None:
            # durable BEFORE buffered: a crash after this line salvages it
            self._journal.append("upload_received", round=self._round, child=child_id,
                                 ct=ps.ct, weight=float(ps.weight), count=int(ps.count))
        self._buffer[child_id] = ps
        self._buffered_nbytes += ps.nbytes
        self.peak_buffered_nbytes = max(self.peak_buffered_nbytes, self._buffered_nbytes)
        return True

    @property
    def buffered_nbytes(self) -> int:
        return self._buffered_nbytes

    def received(self) -> int:
        return len(self._buffer)

    def quorum_met(self) -> bool:
        return self.received() >= quorum_size(max(1, len(self.expected())),
                                              self.quorum_frac)

    def all_received(self) -> bool:
        return self.received() >= len(self.expected())

    def _close_common(self):
        """Shared close tail: cancel the deadline, evict the missing, return
        (ordered contribs or None when below quorum, missing).

        The quorum is judged against the PRE-eviction expectation: the
        children that just went missing are the ones the quorum counts, so
        evicting them first would let one survivor meet a quorum of one."""
        self._deadline.cancel()
        if self._journal is not None:
            # the close is the edge's commit point
            self._journal.append("round_closed", durable=False, round=int(self._round or 0))
            self._journal.reset()
        expected = self.expected()
        missing = [c for c in expected if c not in self._buffer]
        need = quorum_size(max(1, len(expected)), self.quorum_frac)
        for c in missing:
            self._evicted.add(c)
        if not self._buffer or self.received() < need:
            logger.warning("tier %d node %d below quorum: %d/%d children reported",
                           self.tier, self.node_id, self.received(), len(expected))
            self._round = None
            return None, missing
        order = sorted(self._buffer)  # canonical order: child id
        contribs = [(self._buffer[c].ct, self._buffer[c].weight) for c in order]
        counts = [self._buffer[c].count for c in order]
        self._round = None
        return (contribs, counts), missing

    def close_round(self, key) -> Tuple[Optional[PartialSum], List[int]]:
        """Reduce the received children (quorum permitting) into a
        re-encoded PartialSum for the uplink, and evict the missing;
        ``partial`` is None below quorum (the parent counts THIS node
        missing)."""
        closed, missing = self._close_common()
        if closed is None:
            return None, missing
        contribs, counts = closed
        return reduce_cohort(contribs, self.codec, key, counts=counts,
                             agg_robust=self.agg_robust), missing

    def close_round_root(self) -> Tuple[Optional[Tree], float, List[int]]:
        """Root variant: decode the global mean instead of re-encoding —
        the round's one full f32 tree. Returns (mean, weight, missing)."""
        closed, missing = self._close_common()
        if closed is None:
            return None, 0.0, missing
        contribs, _ = closed
        mean, total = finalize_root(contribs, agg_robust=self.agg_robust)
        return mean, total, missing

    def readmit(self, child_id: int) -> bool:
        """Rejoin: any sign of life from an evicted child readmits it for
        the next round."""
        if int(child_id) not in self._evicted:
            return False
        self._evicted.discard(int(child_id))
        return True

    def evicted(self) -> List[int]:
        return sorted(self._evicted)


# -- leaf tier: one batched pass a chunk -------------------------------------
def leaf_chunk(codec: Codec, meta, delta_fn: DeltaFn, ef: bool, agg: str, trim: float,
               keys: torch.Tensor, weights: torch.Tensor,
               residuals: Sequence[torch.Tensor]):
    """generate → (EF) → encode → reduce for a whole chunk, on the keys' device.

    ``keys`` ``[C, 2]`` per-client key data, ``weights`` ``[C]`` f32 (0 for
    dead or padded slots), ``residuals`` the ``[C, *shape]`` EF leaves
    (empty when ``ef`` is False). Client ``c``'s delta is ``delta_fn`` of
    ``fold_in(keys[c], 1)`` and its upload is encoded under ``fold_in(keys[c],
    2)``, as the reference's program draws them. With ``agg='mean'`` returns
    the cohort's *unnormalized* weighted-sum leaves, summed over the rows in
    a fixed pairwise order; with ``'trimmed_mean'``/``'median'`` the
    coordinate-wise statistic over the live (weight > 0) rows — already the
    cohort MEAN. Second value: the new EF residuals (``()`` without EF)."""
    with torch.no_grad():
        delta_keys, enc_keys = threefry.fold_in_many(keys, (1, 2)).unbind(1)
        leaves = tuple(delta_fn(delta_keys))
        if ef:
            leaves = tuple(x + r for x, r in zip(leaves, residuals))
        enc = codec.encode_batch(leaves, meta, enc_keys)
        new_res: Tuple[torch.Tensor, ...] = ()
        if ef:
            new_res = tuple(
                (c - codec.decode_leaf_batch(parts, dt, sh).to(c.dtype)) if _is_float_meta(dt)
                else torch.zeros_like(c)
                for c, parts, (dt, sh) in zip(leaves, enc, meta))
        w = weights.float()
        if agg == "mean":
            summed = tuple(
                ordered_row_sum(codec.weighted_rows(parts, w, dt, sh)).to(_dtype_from_str(dt))
                if _is_float_meta(dt) else _raw_weighted_sum(parts[0], w)
                for parts, (dt, sh) in zip(enc, meta))
            return summed, new_res
        from fedml_tpu_torch.integrity.robust_agg import masked_robust_leaf

        valid = w > 0
        out = []
        for parts, (dt, sh) in zip(enc, meta):
            dec = (codec.decode_leaf_batch(parts, dt, sh) if _is_float_meta(dt)
                   else parts[0]).float()
            out.append(masked_robust_leaf(dec, valid, agg, trim).float())
        return tuple(out), new_res


class LeafCohort:
    """One edge's virtual leaf clients, reduced in fixed-size chunks on
    ``device``.

    ``client_ids`` are the global client ids owned by this edge; ``weights``
    their sample weights (default 1.0). ``ef=True`` keeps stacked
    per-client error-feedback residuals on the device (the clients' own
    state, held at the edge tier here): O(cohort × tree f32), the
    small-cohort mode.
    """

    def __init__(self, tier: int, edge_id: int, client_ids: np.ndarray, codec: Codec,
                 meta, delta_fn: DeltaFn, seed: int, chunk: int = 2048, ef: bool = False,
                 weights: Optional[np.ndarray] = None, agg_robust: Optional[str] = None,
                 device: DeviceLike = "cuda"):
        self.tier = int(tier)
        self.edge_id = int(edge_id)
        self.client_ids = np.asarray(client_ids, np.int64)
        self.codec = codec
        self.meta = meta
        self.delta_fn = delta_fn
        self.seed = int(seed)
        self.device = resolve_device(device)
        n = len(self.client_ids)
        # a robust statistic is not chunk-decomposable (the per-coordinate
        # sort needs every client), so a robust cohort is ONE chunk
        self._robust = None
        if agg_robust:
            from fedml_tpu_torch.integrity import parse_robust_spec

            self._robust = parse_robust_spec(agg_robust)
        self.returns_mean = self._robust is not None
        if self._robust is not None:
            chunk = _next_pow2(n)
        # bucket the chunk to the cohort: never padding more than 2x
        self.chunk = max(1, min(int(chunk), _next_pow2(n)))
        self.ef = bool(ef)
        self.weights = (np.ones(n, np.float32) if weights is None
                        else np.asarray(weights, np.float32))
        self.evicted_mask = np.zeros(n, bool)
        self._residuals: Optional[List[torch.Tensor]] = None
        if self.ef:
            self._residuals = [
                torch.zeros((n,) + tuple(sh), device=self.device,
                            dtype=torch.float32 if _is_float_meta(dt) else _dtype_from_str(dt))
                for dt, sh in meta]

    def n_expected(self) -> int:
        return int((~self.evicted_mask).sum())

    def evicted_ids(self) -> np.ndarray:
        return self.client_ids[self.evicted_mask]

    def evict(self, dead_local: np.ndarray) -> np.ndarray:
        """Mark locally-indexed clients evicted; returns their global ids."""
        fresh = dead_local[~self.evicted_mask[dead_local]]
        self.evicted_mask[fresh] = True
        return self.client_ids[fresh]

    def readmit(self, local_idx: np.ndarray) -> np.ndarray:
        """Rejoin: readmit clients and RESET their EF residual rows — a
        rejoiner's pre-drop quantization error must not leak into its
        post-rejoin uploads."""
        local_idx = np.asarray(local_idx, np.int64)
        back = local_idx[self.evicted_mask[local_idx]]
        self.evicted_mask[back] = False
        if self._residuals is not None and len(back):
            rows = torch.from_numpy(back).to(self.device)
            for r in self._residuals:
                r[rows] = 0
        return self.client_ids[back]

    def residual_rows(self, local_idx: int) -> List[torch.Tensor]:
        if self._residuals is None:
            return []
        return [r[int(local_idx)].cpu() for r in self._residuals]

    def _chunk_keys(self, round_idx: int, cids: np.ndarray) -> torch.Tensor:
        kd = derive_key_data_batch(self.seed, round_idx, cids)
        return torch.from_numpy(kd.astype(np.int64)).to(self.device)

    def reduce(self, round_idx: int, alive_local: np.ndarray) -> Tuple[
            Optional[List[torch.Tensor]], float, int]:
        """Reduce the round's surviving cohort to unnormalized sum leaves on
        the device: ``(sum_leaves, total_weight, n_received)``, sum_leaves
        None when nobody reported. With ``agg_robust`` (``returns_mean``)
        the leaves are already the cohort's robust MEAN."""
        live = np.asarray(alive_local, bool) & ~self.evicted_mask
        n = len(self.client_ids)
        w_round = np.where(live, self.weights, 0.0).astype(np.float32)
        n_received = int(live.sum())
        if n_received == 0:
            return None, 0.0, 0
        agg, trim = ("mean", 0.0) if self._robust is None else self._robust
        sum_leaves = None
        for start in range(0, n, self.chunk):
            idx = np.arange(start, min(start + self.chunk, n))
            pad = self.chunk - len(idx)
            cids = np.concatenate([self.client_ids[idx], np.zeros(pad, np.int64)])
            w = torch.from_numpy(np.concatenate([w_round[idx], np.zeros(pad, np.float32)]))
            res: Tuple[torch.Tensor, ...] = ()
            if self.ef:
                rows = torch.from_numpy(idx).to(self.device)
                res = tuple(torch.cat([r[rows], r.new_zeros((pad,) + tuple(r.shape[1:]))])
                            for r in self._residuals)
            summed, new_res = leaf_chunk(self.codec, self.meta, self.delta_fn, self.ef, agg,
                                         trim, self._chunk_keys(round_idx, cids),
                                         w.to(self.device), res)
            if self.ef:
                # only clients that trained advance their residual
                trained = live[idx]
                if trained.any():
                    dst = torch.from_numpy(idx[trained]).to(self.device)
                    src = torch.from_numpy(np.nonzero(trained)[0]).to(self.device)
                    for r, nr in zip(self._residuals, new_res):
                        r[dst] = nr[src]
            sum_leaves = (list(summed) if sum_leaves is None
                          else [a + b for a, b in zip(sum_leaves, summed)])
        return sum_leaves, float(w_round.sum()), n_received
