"""Hierarchical federation — counterpart of ``fedml_tpu/hierarchy``:
aggregation trees and buffered-async (FedBuff).

- **Aggregation trees** — leaf clients upload compressed deltas to edge
  aggregators; every tier reduces its cohort with the dequant-fused
  weighted sum and forwards a :class:`~fedml_tpu_torch.hierarchy.
  partial_sum.PartialSum` (re-encoded blocks + accumulated weight) upward,
  so no tier builds a per-contributor f32 tree. Each cohort closes on
  all-received or quorum, evicts the missing and readmits rejoiners (EF
  rows reset at the edge); an interior aggregator journals its buffer and
  restarts from it. :class:`TreeRunner` runs a 100k+-client N-tier
  federation in one process on one device, a leaf chunk at a time in one
  batched pass, with chaos at any tier and per-tier ``tier/<d>/...``
  counters; ``secagg=True`` masks each edge's cohort
  (``privacy/secagg/hierarchy.py``).
- **FedBuff** (:mod:`fedml_tpu_torch.hierarchy.fedbuff`) — the bounded,
  staleness-weighted buffer of delta contributions the asynchronous
  cross-silo server flushes through the fused weighted sum.

``python -m fedml_tpu_torch.cli tree`` runs a seeded scenario and prints
one JSON line.
"""
from fedml_tpu_torch.hierarchy.edge import EdgeAggregator, LeafCohort
from fedml_tpu_torch.hierarchy.fedbuff import FedBuffBuffer, staleness_weight
from fedml_tpu_torch.hierarchy.partial_sum import (
    PartialSum,
    compressed_nbytes,
    finalize_root,
    flat_reference,
    reduce_cohort,
)
from fedml_tpu_torch.hierarchy.runner import (
    EdgeKillWindow,
    KillWindow,
    TreeRunner,
    default_template,
)
from fedml_tpu_torch.hierarchy.tree import TreeTopology

__all__ = [
    "EdgeAggregator",
    "EdgeKillWindow",
    "FedBuffBuffer",
    "KillWindow",
    "LeafCohort",
    "PartialSum",
    "TreeRunner",
    "TreeTopology",
    "compressed_nbytes",
    "default_template",
    "finalize_root",
    "flat_reference",
    "reduce_cohort",
    "staleness_weight",
]
