"""Pairwise-mask arithmetic over the quantized block domain — counterpart
of ``fedml_tpu/privacy/secagg/masking.py``, the same numpy on the host.

Each client adds to its quantized words a zero-sum family of pairwise
masks in the same integer domain, wrapping mod ``2^k``:

    y_i = q_i + Σ_{j≠i} sign(i,j) · PRG(s_ijr)      (mod 2^k)

with ``sign(i,j) = +1`` when ``i < j`` else ``-1`` and ``s_ijr`` a
per-(round, i, j) seed both endpoints derive from their X25519 secret.
The survivors' sum cancels every mask whose two endpoints survived; the
masks paired with an evicted client are removed through the revealed
seeds (:func:`recovery_adjustment`). The cancellation is exact integer
arithmetic, so the unmasked sum equals the never-masked sum bit for bit.

The masks are numpy Philox streams, the reference's calls exactly: a
torch Philox stream is another stream, and a port client's masks would
then not cancel against a JAX client's. Headroom: every client quantizes
to ``B = (2^(k-1) - 1) // n`` levels so the cohort's true sum fits the
signed range and the mod-``2^k`` residue decodes exactly (``mod_bits`` 4,
8 or 16; at 4 the words pack two to a byte in the encode).
"""
from __future__ import annotations

import hashlib
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = [
    "MOD_BITS_CHOICES",
    "client_bound",
    "mask_leaves",
    "net_mask_leaves",
    "pair_round_seed",
    "recovery_adjustment",
]

MOD_BITS_CHOICES = (4, 8, 16)

# host-side mask words are UNPACKED (one word per element) even at
# mod_bits=4 — packing to two nibbles per byte happens only inside the
# jitted encode program, where the wire is assembled
_WORD_DTYPE = {4: np.uint8, 8: np.uint8, 16: np.uint16}


def _check_mod_bits(mod_bits: int) -> int:
    mod_bits = int(mod_bits)
    if mod_bits not in MOD_BITS_CHOICES:
        raise ValueError(
            f"secagg mod_bits must be one of {MOD_BITS_CHOICES}, "
            f"got {mod_bits}")
    return mod_bits


def client_bound(cohort_n: int, mod_bits: int = 8) -> int:
    """Per-client quantization bound B so the cohort sum never wraps.

    Each client's quantized words live in ``[-B, B]``; ``n`` of them sum
    inside ``[-(2^(k-1)-1), 2^(k-1)-1]``, so the wrapped mod-``2^k``
    residue of the unmasked sum is exact. Cohorts larger than
    ``2^(k-1)-1`` have no representable bound — a loud error, not a
    silent wrap."""
    mod_bits = _check_mod_bits(mod_bits)
    n = int(cohort_n)
    if n < 1:
        raise ValueError(f"cohort must have at least 1 client, got {n}")
    bound = ((1 << (mod_bits - 1)) - 1) // n
    if bound < 1:
        raise ValueError(
            f"cohort of {n} clients cannot share a mod-2^{mod_bits} masked "
            f"domain (max {(1 << (mod_bits - 1)) - 1}); raise "
            f"secagg_mod_bits or shrink the cohort")
    return bound


def pair_round_seed(shared_secret: int, round_idx: int) -> int:
    """The per-(round, i, j) PRF key: fold the X25519-agreed pair secret
    with the round index. Revealing one round's seed (dropout recovery)
    exposes nothing about any other round's masks."""
    h = hashlib.sha256(
        int(shared_secret).to_bytes(16, "little", signed=False)
        + int(round_idx).to_bytes(8, "little", signed=True)
        + b"fedml_tpu/secagg/v2")
    return int.from_bytes(h.digest()[:16], "little")


def _leaf_sizes(meta) -> List[int]:
    return [int(np.prod(sh, dtype=np.int64)) if sh else 1 for _, sh in meta]


def mask_leaves(seed: int, meta, mod_bits: int = 8) -> List[np.ndarray]:
    """One pair's PRG mask, per leaf of a tree described by ``meta``.

    A single Philox stream keyed by ``seed`` covers the whole tree in
    meta order — both endpoints (and the recovery path) slice the same
    stream, so a mask is a pure function of (seed, meta, mod_bits)."""
    mod_bits = _check_mod_bits(mod_bits)
    sizes = _leaf_sizes(meta)
    gen = np.random.Generator(
        np.random.Philox(key=int(seed) & ((1 << 128) - 1)))
    words = gen.integers(0, 1 << mod_bits, size=int(sum(sizes)),
                         dtype=np.uint32)
    out, off = [], 0
    for (dt, sh), n in zip(meta, sizes):
        out.append(words[off:off + n].astype(
            _WORD_DTYPE[mod_bits]).reshape(sh))
        off += n
    return out


def _accumulate(meta, signed_seeds: Sequence[Tuple[int, int]],
                mod_bits: int) -> List[np.ndarray]:
    """Σ sign·PRG(seed) per leaf, wrapping mod 2^k (uint words)."""
    mod_bits = _check_mod_bits(mod_bits)
    dtype = _WORD_DTYPE[mod_bits]
    acc = [np.zeros(sh, dtype) for _, sh in meta]
    for sign, seed in signed_seeds:
        for a, m in zip(acc, mask_leaves(seed, meta, mod_bits)):
            if sign >= 0:
                a += m  # uint wraparound IS the mod-2^k arithmetic
            else:
                a -= m
    if mod_bits < 8:
        # sub-byte domain rides uint8 words: the byte wraparound above
        # is mod-256, which reduces exactly to mod-2^k because 2^k
        # divides 256 — mask down so words stay in [0, 2^k)
        for a in acc:
            a &= (1 << mod_bits) - 1
    return acc


def net_mask_leaves(rank: int, peer_seeds: Dict[int, int], meta,
                    mod_bits: int = 8) -> List[np.ndarray]:
    """A client's NET mask: Σ_{j≠i} sign(i,j)·PRG(s_ijr), per leaf.

    ``peer_seeds`` maps peer rank → per-round pair seed for every OTHER
    member of the round roster. Folding all pairs into one tree means
    the device-side encode adds a single mask tensor per leaf."""
    rank = int(rank)
    signed = [(+1 if rank < int(j) else -1, s)
              for j, s in sorted(peer_seeds.items())]
    return _accumulate(meta, signed, mod_bits)


def recovery_adjustment(pairs: Sequence[Tuple[int, int, int]], meta,
                        mod_bits: int = 8) -> List[np.ndarray]:
    """The sum the server must SUBTRACT after dropout recovery.

    ``pairs`` is ``[(survivor_rank, evicted_rank, revealed_seed), ...]``
    — each survivor applied ``sign(survivor, evicted)·PRG(seed)`` inside
    its upload and the evicted peer's cancelling half never arrived, so
    the same signed mask is reproduced here and removed from the masked
    sum. Exact by construction: recovery restores the bit-identical
    unmasked sum over the survivors."""
    signed = [(+1 if int(i) < int(j) else -1, s) for i, j, s in pairs]
    return _accumulate(meta, signed, mod_bits)
