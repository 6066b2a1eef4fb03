"""Federated analytics ("FA") — counterpart of ``fedml_tpu/fa``: AVG,
TrieHH heavy hitters, union, intersection, cardinality, frequency
estimation, k-percentile and histogram over the cross-silo FSM, in
plaintext or as mergeable sketches on the masked wire (:mod:`.sketch`),
and the tree-scale heavy-hitter federation
(:func:`fedml_tpu_torch.fa.sketch.federation.run_sketch_federation`).
"""
from fedml_tpu_torch.fa.aggregator import create_aggregator
from fedml_tpu_torch.fa.analyzer import create_analyzer
from fedml_tpu_torch.fa.base_frame import FAClientAnalyzer, FAServerAggregator
from fedml_tpu_torch.fa.constants import ALL_TASKS
from fedml_tpu_torch.fa.run_inproc import run_fa_inproc

__all__ = [
    "ALL_TASKS",
    "FAClientAnalyzer",
    "FAServerAggregator",
    "create_aggregator",
    "create_analyzer",
    "run_fa_inproc",
]
