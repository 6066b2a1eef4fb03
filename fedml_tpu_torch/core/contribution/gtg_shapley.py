"""GTG-Shapley — within-round truncated Monte-Carlo Shapley values.

A copy of ``fedml_tpu/core/contribution/gtg_shapley.py`` (Liu et al., "GTG-
Shapley: Efficient and Accurate Participant Contribution Evaluation in
Federated Learning"). The estimator samples permutations of the round's
participants, walks each permutation accumulating marginal utilities of
the *aggregated prefix model*, and truncates a permutation early once the
prefix utility is within ``eps`` of the full-coalition utility (the
"guided truncation"). For small cohorts (≤ ``exact_threshold``) it
enumerates every permutation — the exact Shapley value.

``utility_fn(subset_idxs) -> float`` is the round utility (e.g. validation
accuracy of the subset's aggregate); ``utility_empty`` is v(∅) — the
previous round's global model utility.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Sequence

import numpy as np


def gtg_shapley(
    n: int,
    utility_fn: Callable[[Sequence[int]], float],
    utility_empty: float,
    max_permutations: int = 64,
    eps: float = 1e-3,
    convergence_tol: float = 1e-3,
    exact_threshold: int = 5,
    seed: int = 0,
) -> np.ndarray:
    """Shapley value per participant index 0..n-1."""
    cache: Dict[frozenset, float] = {frozenset(): float(utility_empty)}

    def v(subset: Sequence[int]) -> float:
        key = frozenset(subset)
        if key not in cache:
            cache[key] = float(utility_fn(sorted(subset)))
        return cache[key]

    phi = np.zeros(n, np.float64)
    if n == 0:
        return phi
    v_full = v(range(n))

    if n <= exact_threshold:
        perms = list(itertools.permutations(range(n)))
    else:
        rng = np.random.default_rng(seed)
        perms = [rng.permutation(n) for _ in range(max_permutations)]

    count = 0
    prev_mean = None
    for perm in perms:
        v_prev = cache[frozenset()]
        prefix: List[int] = []
        for c in perm:
            prefix.append(int(c))
            if abs(v_full - v_prev) < eps:
                # guided truncation: the remaining marginals are ~0
                v_cur = v_prev
            else:
                v_cur = v(prefix)
            phi[int(c)] += v_cur - v_prev
            v_prev = v_cur
        count += 1
        # convergence check on the running estimate (MC mode only)
        if n > exact_threshold and count >= 8 and count % 4 == 0:
            mean = phi / count
            if prev_mean is not None and np.max(
                np.abs(mean - prev_mean)
            ) < convergence_tol:
                break
            prev_mean = mean
    return phi / count


def leave_one_out(
    n: int,
    utility_fn: Callable[[Sequence[int]], float],
) -> np.ndarray:
    """phi_i = v(N) − v(N \\ {i}) (parity: the reference's LOO assessor)."""
    v_full = float(utility_fn(list(range(n))))
    out = np.zeros(n, np.float64)
    for i in range(n):
        rest = [j for j in range(n) if j != i]
        out[i] = v_full - float(utility_fn(rest))
    return out


def mr_shapley(
    n: int,
    utility_fn: Callable[[Sequence[int]], float],
    utility_empty: float,
) -> np.ndarray:
    """Exact per-round Shapley over the full power set.

    Parity: ``core/contribution/mr_shapley_value.py`` (the "MR" assessor
    enumerates every coalition each round and sums the exact values
    across rounds; the cross-round summation lives in the manager).
    φ_i = Σ_{S ∌ i} |S|!·(n−|S|−1)!/n! · [v(S∪{i}) − v(S)].
    """
    import math

    members = list(range(n))
    v: Dict[frozenset, float] = {frozenset(): float(utility_empty)}
    for r in range(1, n + 1):
        for subset in itertools.combinations(members, r):
            v[frozenset(subset)] = float(utility_fn(list(subset)))
    fact = [math.factorial(k) for k in range(n + 1)]
    out = np.zeros(n, np.float64)
    for i in members:
        others = [j for j in members if j != i]
        for r in range(0, n):
            w = fact[r] * fact[n - r - 1] / fact[n]
            for subset in itertools.combinations(others, r):
                s = frozenset(subset)
                out[i] += w * (v[s | {i}] - v[s])
    return out
