"""Partial sums in the compressed block domain, the tree's wire unit —
counterpart of ``fedml_tpu/hierarchy/partial_sum.py``.

What travels up the tree is a :class:`PartialSum`: a
:class:`~fedml_tpu_torch.compression.CompressedTree` (int8 blocks and
scales, bf16 halves, ...) holding the cohort's *weighted mean*, plus the
accumulated sample weight of everything under it. A tier combines its
children's partial sums with the dequant-fused weighted sum
(``fused_weighted_sum``: the stacked blocks reduce on their device) and
re-encodes the result for its own uplink, so the only f32 tree a tier
builds is its one cohort aggregate.

Carrying (mean, weight) keeps the arithmetic associative by construction::

    combine(x, y).mean   = (Wx·x.mean + Wy·y.mean) / (Wx + Wy)
    combine(x, y).weight = Wx + Wy

so 2-, 3- and 4-tier trees and flat aggregation compute the same weighted
mean: bit for bit with the identity codec on exactly representable data,
within one re-quantization a tier for int8.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression.codecs import Codec, CompressedTree, fused_weighted_sum
from fedml_tpu_torch.utils.tree import Tree

__all__ = [
    "PartialSum",
    "compressed_nbytes",
    "finalize_root",
    "flat_reference",
    "reduce_cohort",
]


class PartialSum:
    """A cohort's aggregate, ready for the uplink.

    ``ct``      the cohort weighted mean, encoded by the tier codec
    ``weight``  accumulated sample weight under this subtree
    ``count``   leaf contributions folded in (diagnostics only)
    """

    __slots__ = ("ct", "weight", "count")

    def __init__(self, ct: CompressedTree, weight: float, count: int):
        self.ct = ct
        self.weight = float(weight)
        self.count = int(count)

    @property
    def nbytes(self) -> int:
        return compressed_nbytes(self.ct)

    def __repr__(self) -> str:  # pragma: no cover
        return (f"PartialSum(codec={self.ct.codec}, weight={self.weight:g}, "
                f"count={self.count})")


def compressed_nbytes(ct: CompressedTree) -> int:
    """Wire bytes of a compressed tree's blocks (q/scales/values/indices):
    the encoded arrays only, not the few hundred bytes of envelope."""
    total = 0
    for parts in ct.arrays:
        for a in parts:
            if isinstance(a, torch.Tensor):
                total += a.numel() * a.element_size()
            else:
                total += np.asarray(a).nbytes
    return total


def _weighted_mean(contribs: Sequence[Tuple[CompressedTree, float]]) -> Tuple[Tree, float]:
    """The dequant-fused weighted mean over (ct, weight) contributions; the
    weights normalized in float64 and rounded to f32, as the reference's."""
    if not contribs:
        raise ValueError("empty cohort: nothing to reduce")
    weights = np.asarray([w for _, w in contribs], np.float64)
    total = float(weights.sum())
    if total <= 0:
        raise ValueError(f"cohort weights must sum > 0, got {total}")
    mean = fused_weighted_sum([ct for ct, _ in contribs],
                              (weights / total).astype(np.float32))
    return mean, total


def _robust_mean(contribs: Sequence[Tuple[CompressedTree, float]],
                 agg_robust: str) -> Tuple[Tree, float]:
    """The coordinate-wise robust statistic over the cohort's contributions,
    deliberately unweighted (a subtree claiming a huge weight is the lever
    robustness removes); the accumulated weight still flows up."""
    from fedml_tpu_torch.integrity import fused_robust_sum, parse_robust_spec

    if not contribs:
        raise ValueError("empty cohort: nothing to reduce")
    mode, trim = parse_robust_spec(agg_robust)
    total = float(np.sum([w for _, w in contribs], dtype=np.float64))
    if total <= 0:
        raise ValueError(f"cohort weights must sum > 0, got {total}")
    return fused_robust_sum([ct for ct, _ in contribs], mode, trim), total


def reduce_cohort(contribs: Sequence[Tuple[CompressedTree, float]], out_codec: Codec,
                  key: Any, counts: Optional[Sequence[int]] = None,
                  agg_robust: Optional[str] = None) -> PartialSum:
    """Reduce one cohort's compressed contributions into a PartialSum: the
    fused weighted mean (or, with ``agg_robust``, the fused robust
    statistic), re-encoded by ``out_codec`` under ``key`` for the uplink."""
    if agg_robust:
        mean, total = _robust_mean(contribs, agg_robust)
    else:
        mean, total = _weighted_mean(contribs)
    ct = out_codec.encode(mean, key=key, is_delta=contribs[0][0].is_delta)
    count = int(sum(counts)) if counts is not None else len(contribs)
    return PartialSum(ct, total, count)


def finalize_root(contribs: Sequence[Tuple[CompressedTree, float]],
                  agg_robust: Optional[str] = None) -> Tuple[Tree, float]:
    """Close the global round: the fused weighted mean (or robust statistic)
    of the top tier's partial sums, decoded once — the round's only full f32
    tree."""
    if agg_robust:
        return _robust_mean(contribs, agg_robust)
    return _weighted_mean(contribs)


def flat_reference(contribs: Sequence[Tuple[CompressedTree, float]]) -> Tree:
    """Flat (tree-less) aggregation of the same contributions: the baseline
    of the associativity checks."""
    return _weighted_mean(contribs)[0]
