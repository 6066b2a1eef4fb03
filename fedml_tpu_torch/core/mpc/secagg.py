"""Bonawitz secure-aggregation primitives — counterpart of
``fedml_tpu/core/mpc/secagg.py``: Shamir sharing (reconstruction is one
Lagrange interpolation to x = 0 through the LCC kernel), additive shares,
X25519 key agreement, Philox PRG masks, and the client's and server's math
over one flat int64 field vector per model.

The key exchange is the port's ``privacy/secagg/keys`` (``cryptography``
where it imports, else the RFC 7748 ladder: the same secrets either way),
not a finite-field DH over the aggregation prime: the adversary is the
server, which relays every public key. Secrets come from OS entropy; a
seed exists only so tests reproduce.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from fedml_tpu_torch.core.mpc.finite import DEFAULT_PRIME
from fedml_tpu_torch.core.mpc.lcc import field_matmul, gen_lagrange_coeffs
from fedml_tpu_torch.privacy.secagg import keys


# -- Shamir secret sharing ----------------------------------------------------------

def shamir_share(secret: np.ndarray, n_shares: int, threshold: int,
                 p: int = DEFAULT_PRIME, rng: Optional[np.random.Generator] = None
                 ) -> np.ndarray:
    """Split ``secret`` [dim] into ``n_shares`` shares, any ``threshold + 1``
    of which reconstruct: a degree-``threshold`` polynomial with the secret
    at x = 0, evaluated at x = 1..n. Returns [n_shares, dim]."""
    rng = rng or np.random.default_rng()
    secret = np.mod(np.asarray(secret, np.int64), p)
    dim = secret.shape[0]
    coeffs = np.concatenate(
        [secret[None], rng.integers(0, p, size=(threshold, dim)).astype(np.int64)])
    xs = np.arange(1, n_shares + 1, dtype=np.int64)
    V = np.ones((n_shares, threshold + 1), np.int64)
    for k in range(1, threshold + 1):
        V[:, k] = (V[:, k - 1] * xs) % p
    return field_matmul(V, coeffs, p)


def shamir_reconstruct(shares: np.ndarray, idxs: Sequence[int],
                       p: int = DEFAULT_PRIME) -> np.ndarray:
    """The secret from shares at the 1-based points ``idxs``."""
    pts = np.asarray(idxs, np.int64)
    U = gen_lagrange_coeffs(pts, np.zeros(1, np.int64), p)  # [1, k]
    return field_matmul(U, np.asarray(shares, np.int64), p)[0]


def additive_share(secret: np.ndarray, n_out: int, p: int = DEFAULT_PRIME,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    secret = np.mod(np.asarray(secret, np.int64), p)
    parts = rng.integers(0, p, size=(n_out - 1, secret.shape[0])).astype(np.int64)
    last = np.mod(secret - parts.sum(axis=0), p)
    return np.concatenate([parts, last[None]])


# -- key exchange ---------------------------------------------------------------------

def kx_keygen(rng: Optional[np.random.Generator] = None) -> Tuple[bytes, bytes]:
    """An X25519 key pair → (private scalar bytes, 32-byte public key);
    ``rng`` draws the scalar (tests only), else OS entropy."""
    return keys.kx_keygen(None if rng is None else rng.bytes(32))


def kx_agree(my_sk: bytes, their_pk: bytes) -> int:
    """Shared secret → 128-bit PRG seed (SHA-256 of the raw exchange)."""
    return keys.kx_agree(my_sk, their_pk)


# -- PRG masks ---------------------------------------------------------------------------

def prg_mask(seed: int, dim: int, p: int = DEFAULT_PRIME) -> np.ndarray:
    """Deterministic field vector from a shared seed (Philox counter PRG)."""
    bits = np.random.Generator(np.random.Philox(key=seed & ((1 << 128) - 1)))
    return bits.integers(0, p, size=dim).astype(np.int64)


# -- the SecAgg math, endpoint by endpoint -------------------------------------------------

class SecAggClient:
    """A client's self mask and pairwise masks over one round:

        y_i = x_i + b_i + Σ_{j: i<j} s_ij − Σ_{j: j<i} s_ij   (mod p)

    s_ij = PRG(DH(i, j)) cancels pairwise; b_i = PRG(self seed) is removed
    by the server from the survivors' Shamir shares of the self seeds,
    while the pairwise seeds of the dropped clients are revealed instead."""

    def __init__(self, client_id: int, n_clients: int, threshold: int, dim: int,
                 p: int = DEFAULT_PRIME, seed: Optional[int] = None):
        self.id = int(client_id)
        self.n = int(n_clients)
        self.t = int(threshold)
        self.dim = int(dim)
        self.p = int(p)
        self.rng = (np.random.default_rng() if seed is None
                    else np.random.default_rng(seed * 7919 + self.id))
        self.sk, self.pk = kx_keygen(None if seed is None else self.rng)
        # in [0, p): the seed is Shamir-shared over GF(p)
        self.self_seed = int(self.rng.integers(0, self.p))
        self.pairwise: Dict[int, int] = {}

    def set_peer_keys(self, pks: Dict[int, bytes]) -> None:
        for j, pk in pks.items():
            if j != self.id:
                self.pairwise[j] = kx_agree(self.sk, pk)

    def self_seed_shares(self) -> np.ndarray:
        """Shamir shares of the self-mask seed, one per client."""
        return shamir_share(np.array([self.self_seed % self.p], np.int64),
                            self.n, self.t, self.p, self.rng)

    def mask(self, x_finite: np.ndarray) -> np.ndarray:
        y = np.mod(x_finite + prg_mask(self.self_seed, self.dim, self.p), self.p)
        for j, key in self.pairwise.items():
            s = prg_mask(key, self.dim, self.p)
            y = np.mod(y + s if self.id < j else y - s, self.p)
        return y

    def pairwise_seed(self, j: int) -> int:
        return self.pairwise[j]


class SecAggServer:
    """The server's unmasking from the survivors' seed shares and the
    dropped clients' revealed pairwise seeds."""

    def __init__(self, n_clients: int, threshold: int, dim: int, p: int = DEFAULT_PRIME):
        self.n, self.t, self.dim, self.p = n_clients, threshold, dim, p

    def aggregate(self, masked: Dict[int, np.ndarray],
                  self_seed_shares: Dict[int, Dict[int, np.ndarray]],
                  dropped_pairwise: Optional[Dict[int, Dict[int, int]]] = None
                  ) -> np.ndarray:
        """Σ of the survivors' masked vectors with every mask stripped.

        ``masked``: {client_id: y_i} of the survivors; ``self_seed_shares``:
        {owner_id: {holder_id: share_row}}; ``dropped_pairwise``:
        {dropped_id: {survivor_id: pairwise_seed}}."""
        survivors = sorted(masked)
        agg = np.zeros(self.dim, np.int64)
        for i in survivors:
            agg = np.mod(agg + masked[i], self.p)
        for i in survivors:
            holders = sorted(self_seed_shares[i])[: self.t + 1]
            shares = np.stack([self_seed_shares[i][h] for h in holders])
            seed = int(shamir_reconstruct(shares, [h + 1 for h in holders], self.p)[0])
            agg = np.mod(agg - prg_mask(seed, self.dim, self.p), self.p)
        for d, seeds in (dropped_pairwise or {}).items():
            for i in survivors:
                s = prg_mask(seeds[i], self.dim, self.p)
                # survivor i applied +s if i < d else -s; remove it
                agg = np.mod(agg - s if i < d else agg + s, self.p)
        return agg
