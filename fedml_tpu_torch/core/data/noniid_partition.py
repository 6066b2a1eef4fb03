"""Non-IID Dirichlet partitioning — a copy of
``fedml_tpu/core/data/noniid_partition.py`` (numpy only, the same draws).

Semantics parity with ``core/data/noniid_partition.py:6-130`` in the
reference: per-class Dirichlet(alpha) proportions across clients, with the
balancing rule that a client already holding >= N/num_clients samples gets
zero share of further classes (same rebalancing trick as the reference's
``partition_class_samples_with_dirichlet_distribution``).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def partition_class_samples_with_dirichlet_distribution(
    N: int,
    alpha: float,
    client_num: int,
    idx_batch: List[List[int]],
    idx_k: np.ndarray,
    rng: np.random.Generator,
):
    rng.shuffle(idx_k)
    proportions = rng.dirichlet(np.repeat(alpha, client_num))
    # zero out clients already at capacity, renormalize
    proportions = np.array(
        [p * (len(idx_j) < N / client_num) for p, idx_j in zip(proportions, idx_batch)]
    )
    s = proportions.sum()
    if s <= 0:
        proportions = np.full(client_num, 1.0 / client_num)
    else:
        proportions = proportions / s
    cuts = (np.cumsum(proportions) * len(idx_k)).astype(int)[:-1]
    idx_batch = [
        idx_j + idx.tolist() for idx_j, idx in zip(idx_batch, np.split(idx_k, cuts))
    ]
    min_size = min(len(idx_j) for idx_j in idx_batch)
    return idx_batch, min_size


def non_iid_partition_with_dirichlet_distribution(
    label_list: np.ndarray,
    client_num: int,
    classes: int,
    alpha: float,
    seed: int = 0,
    task: str = "classification",
) -> Dict[int, np.ndarray]:
    """Return {client_idx: sample_index_array} with Dirichlet(alpha) skew."""
    label_list = np.asarray(label_list)
    N = label_list.shape[0]
    rng = np.random.default_rng(seed)
    min_size = 0
    idx_batch: List[List[int]] = [[] for _ in range(client_num)]
    while min_size < 10 and N >= 10 * client_num:
        idx_batch = [[] for _ in range(client_num)]
        for k in range(classes):
            idx_k = np.where(label_list == k)[0]
            idx_batch, min_size = partition_class_samples_with_dirichlet_distribution(
                N, alpha, client_num, idx_batch, idx_k, rng
            )
    if N < 10 * client_num:  # tiny datasets: round-robin fallback
        order = rng.permutation(N)
        idx_batch = [order[i::client_num].tolist() for i in range(client_num)]
    net_dataidx_map = {}
    for i in range(client_num):
        rng.shuffle(idx_batch[i])
        net_dataidx_map[i] = np.asarray(idx_batch[i], dtype=np.int64)
    return net_dataidx_map


def homo_partition(N: int, client_num: int, seed: int = 0) -> Dict[int, np.ndarray]:
    """IID split: shuffle then deal evenly."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(N)
    return {i: np.sort(order[i::client_num]) for i in range(client_num)}


def record_data_stats(label_list: np.ndarray, net_dataidx_map: Dict[int, np.ndarray]):
    return {
        i: {int(c): int(n) for c, n in zip(*np.unique(label_list[idx], return_counts=True))}
        for i, idx in net_dataidx_map.items()
    }
