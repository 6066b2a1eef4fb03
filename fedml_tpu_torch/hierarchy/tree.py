"""Tree topology — counterpart of ``fedml_tpu/hierarchy/tree.py``: N tiers,
contiguous balanced cohorts, no per-client Python objects.

A topology is the node count per tier — ``levels[0] == 1`` (the root),
``levels[-1] == n_clients`` (the virtual leaves) — plus the arithmetic of
the balanced contiguous child ranges. Cohort membership is computed, never
stored, so a million-leaf tree costs a tuple of ints.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["TreeTopology"]


class TreeTopology:
    """``levels[d]`` = number of nodes at tier ``d`` (0 = root)."""

    def __init__(self, levels: Tuple[int, ...]):
        levels = tuple(int(x) for x in levels)
        if len(levels) < 2:
            raise ValueError("a tree needs at least root + leaf tiers")
        if levels[0] != 1:
            raise ValueError(f"tier 0 is the root (1 node), got {levels[0]}")
        for d in range(1, len(levels)):
            if levels[d] < levels[d - 1]:
                raise ValueError(
                    f"tier {d} ({levels[d]} nodes) narrower than its "
                    f"parent tier ({levels[d - 1]})")
        self.levels = levels

    @classmethod
    def build(cls, n_clients: int, tiers: int = 3) -> "TreeTopology":
        """Balanced geometric tree: tier d gets ~n^(d/(tiers-1)) nodes — for
        100k clients and 3 tiers, ~316 edges of ~316 clients."""
        n = int(n_clients)
        t = int(tiers)
        if n < 1:
            raise ValueError(f"n_clients must be >= 1, got {n}")
        if t < 2:
            raise ValueError(f"tiers must be >= 2 (root + leaves), got {t}")
        levels: List[int] = [1]
        for d in range(1, t - 1):
            levels.append(max(levels[-1], int(round(n ** (d / (t - 1))))))
        levels.append(n)
        return cls(tuple(levels))

    @property
    def n_tiers(self) -> int:
        return len(self.levels)

    @property
    def n_clients(self) -> int:
        return self.levels[-1]

    @property
    def leaf_tier(self) -> int:
        return len(self.levels) - 1

    def children(self, tier: int, node: int) -> np.ndarray:
        """Child node indices (at ``tier + 1``) of ``node`` at ``tier`` — the
        balanced contiguous range [node·m//k, (node+1)·m//k)."""
        if not 0 <= tier < self.leaf_tier:
            raise ValueError(f"tier {tier} has no children")
        k = self.levels[tier]
        m = self.levels[tier + 1]
        return np.arange(node * m // k, (node + 1) * m // k, dtype=np.int64)

    def parent(self, tier: int, node: int) -> int:
        """Parent node index (at ``tier - 1``) of ``node`` at ``tier``."""
        if tier <= 0:
            raise ValueError("the root has no parent")
        k = self.levels[tier - 1]
        m = self.levels[tier]
        # the inverse of the contiguous split: the p with lo(p) <= node < hi(p)
        return int((int(node) * k + k - 1) // m) if m else 0

    def describe(self) -> dict:
        return {
            "tiers": self.n_tiers,
            "levels": list(self.levels),
            "clients": self.n_clients,
            "fanout": [round(self.levels[d + 1] / self.levels[d], 1)
                       for d in range(self.n_tiers - 1)],
        }

    def __repr__(self) -> str:  # pragma: no cover
        return f"TreeTopology(levels={self.levels})"
