"""Server-side FA aggregators, one per task — counterpart of
``fedml_tpu/fa/aggregator/__init__.py``. Multi-round tasks (TrieHH trie growth, k-percentile
bisection, histogram range discovery) return done=False with the next
broadcast state. With ``fa_sketch`` set, a task with a sketch form merges
encoded sketches on ``device`` instead
(:mod:`fedml_tpu_torch.fa.sketch.aggregators`).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict

import numpy as np

from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.fa import constants as C
from fedml_tpu_torch.fa.base_frame import FAServerAggregator

_REGISTRY: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def create_aggregator(task: str, args: Any = None,
                      device: DeviceLike = "cuda") -> FAServerAggregator:
    task = (task or "").strip().lower()
    spec = str(getattr(args, "fa_sketch", "") or "") if args is not None \
        else ""
    if spec:
        # sketch mode: the aggregator owns the negotiated spec (the
        # server manager advertises aggregator.sketch_spec on the
        # round-config header); avg has no sketch form and stays plain
        from fedml_tpu_torch.fa.sketch.aggregators import (
            create_sketch_aggregator,
        )

        agg = create_sketch_aggregator(task, args, spec, device)
        if agg is not None:
            return agg
    if task not in _REGISTRY:
        raise ValueError(f"unknown FA task {task!r}; know {sorted(_REGISTRY)}")
    return _REGISTRY[task](args, device)


@register(C.FA_TASK_AVG)
class AvgAggregator(FAServerAggregator):
    def aggregate(self, submissions, round_idx):
        total = sum(s["sum"] for _, s in submissions)
        count = sum(s["count"] for _, s in submissions)
        return None, True, {"avg": total / max(count, 1), "count": count}


@register(C.FA_TASK_FREQ)
class FrequencyEstimationAggregator(FAServerAggregator):
    def aggregate(self, submissions, round_idx):
        counts = Counter()
        for _, s in submissions:
            counts.update({k: int(v) for k, v in s.items()})
        total = max(sum(counts.values()), 1)
        freq = {k: v / total for k, v in sorted(counts.items())}
        return None, True, {"frequencies": freq, "total": total}


@register(C.FA_TASK_UNION)
class UnionAggregator(FAServerAggregator):
    def aggregate(self, submissions, round_idx):
        u = set()
        for _, s in submissions:
            u.update(s)
        return None, True, {"union": sorted(u)}


@register(C.FA_TASK_INTERSECTION)
class IntersectionAggregator(FAServerAggregator):
    def aggregate(self, submissions, round_idx):
        sets = [set(s) for _, s in submissions]
        inter = set.intersection(*sets) if sets else set()
        return None, True, {"intersection": sorted(inter)}


@register(C.FA_TASK_CARDINALITY)
class CardinalityAggregator(FAServerAggregator):
    def aggregate(self, submissions, round_idx):
        u = set()
        for _, s in submissions:
            u.update(s)
        return None, True, {"cardinality": len(u)}


@register(C.FA_TASK_HISTOGRAM)
class HistogramAggregator(FAServerAggregator):
    """Round 0 discovers the global range; round 1 sums bin counts."""

    def __init__(self, args: Any = None, device: DeviceLike = "cuda"):
        super().__init__(args, device)
        self.bins = int(getattr(args, "fa_hist_bins", 10) or 10)
        self._edges = None

    def aggregate(self, submissions, round_idx):
        if self._edges is None:
            lo = min(s["min"] for _, s in submissions)
            hi = max(s["max"] for _, s in submissions)
            hi = hi if hi > lo else lo + 1.0
            self._edges = np.linspace(lo, hi, self.bins + 1)
            return {"edges": self._edges}, False, None
        counts = np.zeros(self.bins, np.int64)
        for _, s in submissions:
            counts += np.asarray(s["counts"], np.int64)
        return None, True, {"edges": self._edges, "counts": counts}


@register(C.FA_TASK_K_PERCENTILE)
class KPercentileElementAggregator(FAServerAggregator):
    """Bisection on the value axis: each round's probe halves the bracket
    around the k-th percentile rank. Parity:
    ``fa/aggregator/k_percentile_element_aggregator.py`` (iterative search).
    """

    def __init__(self, args: Any = None, device: DeviceLike = "cuda"):
        super().__init__(args, device)
        self.k = float(getattr(args, "fa_k_percentile", 50) or 50)
        self.tol = float(getattr(args, "fa_percentile_tol", 1e-3) or 1e-3)
        self.max_iters = int(getattr(args, "fa_percentile_iters", 64) or 64)
        self._lo = self._hi = self._rank = None
        self._iters = 0

    def aggregate(self, submissions, round_idx):
        if self._rank is None:
            total = sum(s["count"] for _, s in submissions)
            self._rank = int(np.ceil(self.k / 100.0 * total))
            self._lo = min(s["min"] for _, s in submissions)
            self._hi = max(s["max"] for _, s in submissions)
            return {"probe": 0.5 * (self._lo + self._hi)}, False, None
        probe = 0.5 * (self._lo + self._hi)
        le = sum(s["le"] for _, s in submissions)
        if le >= self._rank:
            self._hi = probe
        else:
            self._lo = probe
        self._iters += 1
        if self._hi - self._lo <= self.tol or self._iters >= self.max_iters:
            return None, True, {"percentile": self.k,
                                "value": 0.5 * (self._lo + self._hi)}
        return {"probe": 0.5 * (self._lo + self._hi)}, False, None


@register(C.FA_TASK_HEAVY_HITTER_TRIEHH)
class HeavyHitterTrieHHAggregator(FAServerAggregator):
    """Grow the trie one level per round; keep prefixes with ≥ theta votes.

    Prefixes ending in the '$' terminator are discovered heavy-hitter
    words. Parity: ``fa/aggregator/heavy_hitter_triehh_aggregator.py``.
    """

    def __init__(self, args: Any = None, device: DeviceLike = "cuda"):
        super().__init__(args, device)
        self.theta = int(getattr(args, "fa_theta", 2) or 2)
        self.max_depth = int(getattr(args, "fa_max_word_len", 16) or 16) + 1
        self._popular: set = set()
        self._hitters: set = set()
        self._depth = 1

    def init_state(self):
        return {"depth": 1, "popular": []}

    def aggregate(self, submissions, round_idx):
        votes = Counter()
        for _, s in submissions:
            votes.update({k: int(v) for k, v in s.items()})
        survivors = {p for p, v in votes.items() if v >= self.theta}
        self._hitters |= {p[:-1] for p in survivors if p.endswith("$")}
        alive = {p for p in survivors if not p.endswith("$")}
        self._depth += 1
        if not alive or self._depth > self.max_depth:
            return None, True, {"heavy_hitters": sorted(self._hitters)}
        self._popular = alive
        return {"depth": self._depth, "popular": sorted(alive)}, False, None
