"""LightSecAgg, one-shot aggregate-mask reconstruction via LCC —
counterpart of ``fedml_tpu/core/mpc/lightsecagg.py``:

1. every client draws a mask z_i [d], pads it to K equal chunks, appends T
   noise rows and LCC-encodes the K+T rows to N points; the j-th coded row
   goes to client j;
2. the upload is x_i + z_i (mod p);
3. each surviving client sums the coded rows it holds from the survivors:
   one point of the aggregate-mask polynomial;
4. the server interpolates any K+T points back to the K chunks → Σ z_i,
   and subtracts it from Σ (x_i + z_i).

Any ≥ K+T survivors reconstruct; ≤ T colluders learn nothing of one z_i.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from fedml_tpu_torch.core.mpc.lcc import lcc_decode, lcc_encode


def _points(n: int, k: int, t: int, p: int):
    """Betas (data and noise anchors) 1..K+T, then alphas (the clients)
    K+T+1..K+T+N, all distinct mod p."""
    betas = np.arange(1, k + t + 1, dtype=np.int64)
    alphas = np.arange(k + t + 1, k + t + 1 + n, dtype=np.int64)
    return betas % p, alphas % p


def mask_encoding(dim: int, n_clients: int, targeted_number_active_clients: int,
                  privacy_guarantee: int, prime_number: int, local_mask: np.ndarray,
                  rng: Optional[np.random.Generator] = None) -> Dict[int, np.ndarray]:
    """One client's mask as N coded rows, one per receiving client: U =
    ``targeted_number_active_clients`` survivors needed, T =
    ``privacy_guarantee`` colluders tolerated, K = U - T data chunks.
    Returns {receiver_id: coded_row [ceil(d/K)]}."""
    p = int(prime_number)
    n, u, t = int(n_clients), int(targeted_number_active_clients), int(privacy_guarantee)
    k = u - t
    if k <= 0:
        raise ValueError("need targeted_active > privacy_guarantee")
    rng = rng or np.random.default_rng()
    chunk = math.ceil(dim / k)
    z = np.mod(np.asarray(local_mask, np.int64), p)
    padded = np.zeros(chunk * k, np.int64)
    padded[:dim] = z
    rows = padded.reshape(k, chunk)
    noise = rng.integers(0, p, size=(t, chunk)).astype(np.int64)
    X = np.concatenate([rows, noise])  # [K+T, chunk]
    betas, alphas = _points(n, k, t, p)
    coded = lcc_encode(X, betas, alphas, p)  # [N, chunk]
    return {j: coded[j] for j in range(n)}


def compute_aggregate_encoded_mask(encoded_mask_dict: Dict[int, np.ndarray], p: int,
                                   active_clients: Sequence[int]) -> np.ndarray:
    """One client's one-shot message: Σ over the surviving senders of the
    coded rows it holds."""
    agg = np.zeros_like(next(iter(encoded_mask_dict.values())))
    for cid in active_clients:
        agg = np.mod(agg + encoded_mask_dict[cid], p)
    return agg.astype(np.int64)


def decode_aggregate_mask(agg_encoded: Dict[int, np.ndarray], dim: int, n_clients: int,
                          targeted_number_active_clients: int, privacy_guarantee: int,
                          prime_number: int) -> np.ndarray:
    """Server: interpolate U survivors' aggregate points → Σ z_i [dim]."""
    p = int(prime_number)
    u, t = int(targeted_number_active_clients), int(privacy_guarantee)
    k = u - t
    betas, alphas = _points(int(n_clients), k, t, p)
    holders = sorted(agg_encoded)[:u]
    evals = np.stack([agg_encoded[h] for h in holders])
    rec = lcc_decode(evals, alphas[holders], betas[:k], p)  # [K, chunk]
    return rec.reshape(-1)[:dim]


def model_masking(x_finite: np.ndarray, local_mask: np.ndarray,
                  prime_number: int) -> np.ndarray:
    """The upload: x + z mod p."""
    return np.mod(np.asarray(x_finite, np.int64) + local_mask, prime_number)


def aggregate_models_in_finite(masked: List[np.ndarray], prime_number: int) -> np.ndarray:
    agg = np.zeros_like(masked[0])
    for m in masked:
        agg = np.mod(agg + m, prime_number)
    return agg
