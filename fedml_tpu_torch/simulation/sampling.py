"""Round client sampling — a copy of ``fedml_tpu/simulation/sampling.py``.

The same seeded draw as the reference, so a port run selects the same
clients as a JAX run for a given (round, seed).
"""
from __future__ import annotations

from typing import Any, List

import numpy as np


def sample_from_list(
    ids: List[int], per_round: int, round_idx: int, seed: int
) -> List[int]:
    """The seeded client draw: all ids when ``per_round`` covers them, else
    ``per_round`` of them without replacement, sorted."""
    if per_round >= len(ids):
        return list(ids)
    rng = np.random.default_rng(round_idx + seed)
    return sorted(rng.choice(ids, per_round, replace=False).tolist())


def sample_clients(args: Any, round_idx: int) -> List[int]:
    total = int(args.client_num_in_total)
    per_round = min(int(args.client_num_per_round), total)
    return sample_from_list(
        list(range(total)), per_round, round_idx,
        int(getattr(args, "random_seed", 0)),
    )
