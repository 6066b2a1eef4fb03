"""Sketch-domain server aggregators: fused merges over the masked wire —
counterpart of ``fedml_tpu/fa/sketch/aggregators.py``.

Each round's submissions are :class:`CompressedTree` sketches under the
negotiated spec. The server never loops over per-client tables in Python:
every submission is wire-checked against the NEGOTIATED codec instance (a
spoofed spec or hostile geometry raises, naming the client, before anything
merges), moved to the aggregator's ``device``, and the cohort reduces
through the port's dequant-fused weighted sum; the rescale ``rint(mean·n)``
gives back the integer SUM, the only per-round plaintext the server holds.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression import fused_weighted_sum, get_codec
from fedml_tpu_torch.compression.codecs import CompressedTree
from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.fa import constants as C
from fedml_tpu_torch.fa.base_frame import FAServerAggregator
from fedml_tpu_torch.fa.sketch.codec import sketch_spec_for_task
from fedml_tpu_torch.fa.sketch.sketches import (
    DEFAULT_ALPHABET,
    BloomSketch,
    CountMinSketch,
    CountSketch,
    HistogramSketch,
    VoteVectorSketch,
    k_percentile_from_histogram,
)

__all__ = ["SketchServerAggregator", "create_sketch_aggregator"]

_REGISTRY: Dict[str, type] = {}


def _register(*tasks: str):
    def deco(cls):
        for t in tasks:
            _REGISTRY[t] = cls
        return cls

    return deco


def create_sketch_aggregator(task: str, args: Any = None, spec: str = "",
                             device: DeviceLike = "cuda") -> Optional[
        "SketchServerAggregator"]:
    """The sketch aggregator for ``task`` (None → no sketch form)."""
    cls = _REGISTRY.get((task or "").strip().lower())
    return None if cls is None else cls(args, spec, device)


class SketchServerAggregator(FAServerAggregator):
    """Shared shell: spec ownership + the fused cohort merge."""

    task = ""

    def __init__(self, args: Any = None, spec: str = "", device: DeviceLike = "cuda"):
        super().__init__(args, device)
        if not spec or spec in ("auto", "true", "1", "on"):
            spec = sketch_spec_for_task(self.task, args)
        self.sketch_spec = get_codec(str(spec), args).spec  # normalized
        self.hash_seed = int(getattr(args, "random_seed", 0) or 0)
        self.query_items = list(getattr(args, "fa_query_items", []) or [])

    @property
    def codec(self):
        return get_codec(self.sketch_spec, self.args)

    def init_state(self):
        return {"hash_seed": self.hash_seed}

    def _merge_tables(self, submissions: List[Tuple[int, Any]]) -> Tuple[
            Dict[str, np.ndarray], int]:
        """Fused weighted mean of the cohort's sketches, rescaled back to
        the integer SUM. Raises ``ValueError`` on any wire that does not
        match the negotiated spec — the submitter is named."""
        if not submissions:
            raise ValueError("empty FA round: nothing to merge")
        codec = self.codec
        cts = []
        for cid, sub in submissions:
            if not isinstance(sub, CompressedTree):
                raise ValueError(
                    f"FA client {cid} submitted "
                    f"{type(sub).__name__}, expected a CompressedTree "
                    f"under spec {self.sketch_spec!r}")
            if sub.codec != codec.name:
                raise ValueError(
                    f"FA client {cid} submitted codec {sub.codec!r}, "
                    f"negotiated spec is {self.sketch_spec!r}")
            try:
                codec.check_wire(sub)
            except ValueError as e:
                raise ValueError(
                    f"FA client {cid} wire rejected: {e}") from None
            cts.append(self._on_device(sub))
        n = len(cts)
        w = np.full(n, 1.0 / n, np.float32)
        mean = fused_weighted_sum(cts, w)
        merged = {k: np.rint(v.cpu().double().numpy() * n).astype(np.int64)
                  for k, v in mean.items()}
        return merged, n

    def _on_device(self, ct: CompressedTree) -> CompressedTree:
        """The checked wire's blocks on this aggregator's device."""
        arrays = [[torch.as_tensor(p).to(self.device) for p in parts] for parts in ct.arrays]
        return CompressedTree(ct.codec, ct.version, ct.is_delta, ct.raw_nbytes, ct.meta,
                              ct.structure, arrays, ct.sa)


@_register(C.FA_TASK_FREQ)
class FrequencySketchAggregator(SketchServerAggregator):
    task = C.FA_TASK_FREQ

    def aggregate(self, submissions, round_idx):
        merged, _ = self._merge_tables(submissions)
        codec = self.codec
        cls = CountSketch if codec.name == "csk" else CountMinSketch
        sk = cls(codec.width, codec.depth, self.hash_seed)
        sk.load_leaves(merged)
        total = int(sk.table[0].sum())
        estimates = {str(it): sk.query(it) for it in self.query_items}
        return None, True, {"total": total, "estimates": estimates,
                            "epsilon": sk.epsilon,
                            "spec": self.sketch_spec}


class _BloomAggregator(SketchServerAggregator):
    def _merged_bloom(self, submissions) -> Tuple[BloomSketch, int]:
        merged, n = self._merge_tables(submissions)
        codec = self.codec
        sk = BloomSketch(codec.bits, codec.hashes, self.hash_seed)
        sk.load_leaves(merged)
        return sk, n


@_register(C.FA_TASK_UNION)
class UnionSketchAggregator(_BloomAggregator):
    task = C.FA_TASK_UNION

    def aggregate(self, submissions, round_idx):
        sk, _ = self._merged_bloom(submissions)
        members = {str(it): sk.contains(it) for it in self.query_items}
        return None, True, {
            "cardinality": sk.estimate_cardinality(threshold=1),
            "members": members, "spec": self.sketch_spec}


@_register(C.FA_TASK_INTERSECTION)
class IntersectionSketchAggregator(_BloomAggregator):
    task = C.FA_TASK_INTERSECTION

    def aggregate(self, submissions, round_idx):
        sk, n = self._merged_bloom(submissions)
        members = {str(it): sk.contains(it, threshold=n)
                   for it in self.query_items}
        return None, True, {
            "cardinality": sk.estimate_cardinality(threshold=n),
            "members": members, "spec": self.sketch_spec}


@_register(C.FA_TASK_CARDINALITY)
class CardinalitySketchAggregator(_BloomAggregator):
    task = C.FA_TASK_CARDINALITY

    def aggregate(self, submissions, round_idx):
        sk, _ = self._merged_bloom(submissions)
        return None, True, {
            "cardinality": sk.estimate_cardinality(threshold=1),
            "spec": self.sketch_spec}


@_register(C.FA_TASK_HISTOGRAM)
class HistogramSketchAggregator(SketchServerAggregator):
    task = C.FA_TASK_HISTOGRAM

    def aggregate(self, submissions, round_idx):
        merged, _ = self._merge_tables(submissions)
        codec = self.codec
        sk = HistogramSketch(codec.lo, codec.hi, codec.bins)
        sk.load_leaves(merged)
        return None, True, {"edges": sk.edges, "counts": sk.counts,
                            "spec": self.sketch_spec}


@_register(C.FA_TASK_K_PERCENTILE)
class KPercentileSketchAggregator(SketchServerAggregator):
    """k-percentile read off the merged histogram CDF — ONE round,
    where the plaintext task needs a whole bisection conversation."""

    task = C.FA_TASK_K_PERCENTILE

    def __init__(self, args: Any = None, spec: str = "", device: DeviceLike = "cuda"):
        super().__init__(args, spec, device)
        self.k = float(getattr(args, "fa_k_percentile", 50) or 50)

    def aggregate(self, submissions, round_idx):
        merged, _ = self._merge_tables(submissions)
        codec = self.codec
        sk = HistogramSketch(codec.lo, codec.hi, codec.bins)
        sk.load_leaves(merged)
        return None, True, {
            "percentile": self.k,
            "value": k_percentile_from_histogram(sk.counts, sk.edges,
                                                 self.k),
            "spec": self.sketch_spec}


@_register(C.FA_TASK_HEAVY_HITTER_TRIEHH)
class TrieHHSketchAggregator(SketchServerAggregator):
    """Iterative TrieHH over the masked ballot box.

    Each round merges the cohort's vote tables, then *enumerates* the
    candidate prefixes (popular set × alphabet — the server never needs
    to see a raw vote) and point-queries their cells. Prefixes with
    ≥ theta votes survive; '$'-terminated survivors are discovered
    heavy hitters. Count-min overestimates can only ADD candidates for
    the next level, never drop a true heavy hitter.
    """

    task = C.FA_TASK_HEAVY_HITTER_TRIEHH

    def __init__(self, args: Any = None, spec: str = "", device: DeviceLike = "cuda"):
        super().__init__(args, spec, device)
        self.theta = int(getattr(args, "fa_theta", 2) or 2)
        self.max_depth = int(getattr(args, "fa_max_word_len", 16) or 16) + 1
        self.alphabet = str(getattr(args, "fa_alphabet", "")
                            or DEFAULT_ALPHABET)
        self._popular: set = set()
        self._hitters: set = set()
        self._depth = 1

    def init_state(self):
        return {"hash_seed": self.hash_seed, "depth": 1, "popular": []}

    def _candidates(self):
        if self._depth == 1:
            return list(self.alphabet)
        return [p + c for p in sorted(self._popular) for c in self.alphabet]

    def aggregate(self, submissions, round_idx):
        merged, _ = self._merge_tables(submissions)
        codec = self.codec
        sk = VoteVectorSketch(codec.width, codec.depth, self.hash_seed)
        sk.load_leaves(merged)
        votes = sk.read(self._candidates())
        survivors = {p for p, v in votes.items() if v >= self.theta}
        self._hitters |= {p[:-1] for p in survivors if p.endswith("$")}
        alive = {p for p in survivors if not p.endswith("$")}
        self._depth += 1
        if not alive or self._depth > self.max_depth:
            return None, True, {"heavy_hitters": sorted(self._hitters),
                                "spec": self.sketch_spec}
        self._popular = alive
        return {"hash_seed": self.hash_seed, "depth": self._depth,
                "popular": sorted(alive)}, False, None
