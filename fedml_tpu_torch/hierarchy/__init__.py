"""Hierarchical federation — counterpart of ``fedml_tpu/hierarchy``.

Ported: FedBuff (:mod:`fedml_tpu_torch.hierarchy.fedbuff`), the bounded,
staleness-weighted buffer of delta contributions the asynchronous
cross-silo server flushes through the fused weighted sum.

The aggregation trees (``TreeTopology``, ``EdgeAggregator``, the partial
sums, ``TreeRunner``) come with ROADMAP A10.3c: asking this package for
one raises, naming that item.
"""
from fedml_tpu_torch.hierarchy.fedbuff import FedBuffBuffer, staleness_weight

__all__ = ["FedBuffBuffer", "staleness_weight"]

_TREE_NAMES = frozenset({
    "EdgeAggregator", "EdgeKillWindow", "KillWindow", "LeafCohort", "PartialSum",
    "TreeRunner", "TreeTopology", "compressed_nbytes", "default_template",
    "finalize_root", "flat_reference", "reduce_cohort"})


def __getattr__(name: str):
    if name in _TREE_NAMES:
        raise NotImplementedError(
            f"hierarchy.{name}: the aggregation tree comes with ROADMAP A10.3c")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
