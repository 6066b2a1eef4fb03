"""Client-side FA analyzers, one per task — counterpart of
``fedml_tpu/fa/analyzer/__init__.py``. Submissions are plain JSON-able
scalars, dicts and lists: FA payloads are analytics, not models. With
``fa_sketch`` set, a task with a sketch form submits an encoded sketch
instead (:mod:`fedml_tpu_torch.fa.sketch.analyzers`, on ``device``).
"""
from __future__ import annotations

from collections import Counter
from typing import Any, Dict

import numpy as np

from fedml_tpu_torch.device import DeviceLike
from fedml_tpu_torch.fa import constants as C
from fedml_tpu_torch.fa.base_frame import FAClientAnalyzer

_REGISTRY: Dict[str, type] = {}


def register(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls

    return deco


def create_analyzer(task: str, args: Any = None,
                    device: DeviceLike = "cuda") -> FAClientAnalyzer:
    task = (task or "").strip().lower()
    spec = str(getattr(args, "fa_sketch", "") or "") if args is not None \
        else ""
    if spec:
        # sketch mode: submissions become CompressedTree payloads under
        # the server-negotiated spec; tasks with no sketch form (avg)
        # fall through to their plaintext operator
        from fedml_tpu_torch.fa.sketch.analyzers import create_sketch_analyzer

        analyzer = create_sketch_analyzer(task, args, spec, device)
        if analyzer is not None:
            return analyzer
    if task not in _REGISTRY:
        raise ValueError(f"unknown FA task {task!r}; know {sorted(_REGISTRY)}")
    return _REGISTRY[task](args, device)


@register(C.FA_TASK_AVG)
class AvgAnalyzer(FAClientAnalyzer):
    def local_analyze(self, data, server_state, round_idx):
        arr = np.asarray(data, dtype=np.float64)
        return {"sum": float(arr.sum()), "count": int(arr.size)}


@register(C.FA_TASK_FREQ)
class FrequencyEstimationAnalyzer(FAClientAnalyzer):
    def local_analyze(self, data, server_state, round_idx):
        return {str(v): int(c) for v, c in Counter(map(str, data)).items()}


@register(C.FA_TASK_UNION)
class UnionAnalyzer(FAClientAnalyzer):
    def local_analyze(self, data, server_state, round_idx):
        return sorted({str(v) for v in data})


@register(C.FA_TASK_INTERSECTION)
class IntersectionAnalyzer(UnionAnalyzer):
    pass


@register(C.FA_TASK_CARDINALITY)
class CardinalityAnalyzer(UnionAnalyzer):
    pass


@register(C.FA_TASK_HISTOGRAM)
class HistogramAnalyzer(FAClientAnalyzer):
    """Round 0: local (min, max). Round 1+: counts over server bin edges."""

    def local_analyze(self, data, server_state, round_idx):
        arr = np.asarray(data, dtype=np.float64)
        if not server_state:  # range-discovery round
            return {"min": float(arr.min()), "max": float(arr.max())}
        edges = np.asarray(server_state["edges"], np.float64)
        counts, _ = np.histogram(arr, bins=edges)
        return {"counts": counts.astype(np.int64)}


@register(C.FA_TASK_K_PERCENTILE)
class KPercentileElementAnalyzer(FAClientAnalyzer):
    """Round 0: (count, min, max). Later: #values ≤ the server's probe."""

    def local_analyze(self, data, server_state, round_idx):
        arr = np.asarray(data, dtype=np.float64)
        if not server_state:
            return {"count": int(arr.size), "min": float(arr.min()),
                    "max": float(arr.max())}
        probe = float(server_state["probe"])
        return {"le": int((arr <= probe).sum())}


@register(C.FA_TASK_HEAVY_HITTER_TRIEHH)
class HeavyHitterTrieHHAnalyzer(FAClientAnalyzer):
    """Vote on prefixes one character longer than the popular set.

    Words carry a '$' terminator so complete words surface as prefixes.
    Parity: ``fa/analyzer/heavy_hitter_triehh_client_analyzer.py``.
    """

    def local_analyze(self, data, server_state, round_idx):
        words = [str(w) + "$" for w in data]
        depth = int(server_state["depth"]) if server_state else 1
        popular = set(server_state["popular"]) if server_state else set()
        votes = Counter()
        for w in words:
            if len(w) < depth:
                continue
            prefix = w[:depth]
            # depth 1 votes unconditionally (the trie root is always popular)
            if depth > 1 and prefix[:-1] not in popular:
                continue
            votes[prefix] += 1
        return dict(votes)
