"""Mergeable sketch summaries — the FA engine's data structures; the port's
own copy of ``fedml_tpu/fa/sketch/sketches.py`` (host numpy and hashlib).

Every sketch here is a fixed-geometry integer counter array whose
federation-wide aggregate is the elementwise SUM of the client tables, so
the dequant-fused weighted sum (and with it SecAgg masking, the tree's
``PartialSum`` reduction, journaling and screening) aggregates analytics
rounds without knowing the representation. Integer addition is associative
and commutative bit for bit: flat, 2-tier and 3-tier merges agree exactly.

The families:

- :class:`CountMinSketch` — frequency estimation (Cormode &
  Muthukrishnan 2005): ``depth`` rows of ``width`` counters, point query
  the min over rows, overestimate bounded by ``(e/width)·N`` w.h.p.
- :class:`CountSketch` — the signed variant (median-of-rows estimate).
- :class:`BloomSketch` — a counting bit-vector for union / intersection /
  cardinality: in the merged SUM of 0/1 membership vectors, ``>0`` cells
  are the union filter and ``== n_clients`` cells the intersection filter,
  with linear-counting cardinality estimates off the fill fraction.
- :class:`HistogramSketch` — fixed-bin counts over a preset range, with
  quantile / k-percentile read off the merged CDF.
- :class:`VoteVectorSketch` — the TrieHH-style heavy-hitter vote table
  (Zhu et al. 2020): clients vote for prefix extensions by hashing the
  prefix into a count-min table.

Hashing is a seeded multiply-add universal family over ``uint32``
(``((x·A + B) mod 2^32) mod width``); its rows come from a blake2b
personalisation string that is part of the wire (a renamed string would
stop port tables merging with the reference's). The tensor twin in
:mod:`fedml_tpu_torch.fa.sketch.federation` lands in the same cells.
"""
from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "BloomSketch",
    "CountMinSketch",
    "CountSketch",
    "DEFAULT_ALPHABET",
    "HistogramSketch",
    "VoteVectorSketch",
    "hash_family",
    "hash_bucket",
    "hash_sign",
    "item_to_u32",
    "k_percentile_from_histogram",
]

# TrieHH candidate enumeration: the server extends popular prefixes one
# character at a time over this alphabet ('$' terminates a word)
DEFAULT_ALPHABET = "abcdefghijklmnopqrstuvwxyz0123456789_$"

_MASK32 = 0xFFFFFFFF


def item_to_u32(item: Any) -> int:
    """Stable 32-bit id for an arbitrary hashable item.

    Integers map through unchanged (mod 2^32) so tensor-side integer item
    streams and host-side ones land in the same cells; everything else
    hashes its utf-8 string form through blake2b (NOT python ``hash`` —
    that is salted per process and would unmerge sketches).
    """
    if isinstance(item, (bool, np.bool_)):
        item = int(item)
    if isinstance(item, (int, np.integer)):
        return int(item) & _MASK32
    digest = hashlib.blake2b(str(item).encode("utf-8"), digest_size=4)
    return int.from_bytes(digest.digest(), "little")


def hash_family(seed: int, depth: int, salt: str = "cms") -> Tuple[
        np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``depth`` rows of (A, B, C, D) uint32 multiply-add constants.

    Deterministic in (seed, salt): the server and every client (and the
    plaintext reference sketch) derive identical rows, so their tables
    merge cell-for-cell. A and C are forced odd — even multipliers halve
    the output space of a multiply-shift family.
    """
    rows = []
    for r in range(int(depth)):
        h = hashlib.blake2b(
            b"fedml_tpu/fa/sketch/%s/%d/%d" % (
                salt.encode("ascii"), int(seed) & _MASK32, r),
            digest_size=16)
        d = h.digest()
        rows.append([int.from_bytes(d[i:i + 4], "little") for i in
                     (0, 4, 8, 12)])
    arr = np.asarray(rows, np.uint64)
    a, b, c, dd = arr[:, 0], arr[:, 1], arr[:, 2], arr[:, 3]
    return (a | 1).astype(np.uint64), b.astype(np.uint64), \
        (c | 1).astype(np.uint64), dd.astype(np.uint64)


def hash_bucket(x: np.ndarray, a: int, b: int, width: int) -> np.ndarray:
    """``((x·a + b) mod 2^32) mod width`` — one row's bucket map."""
    x = np.asarray(x, np.uint64)
    return (((x * np.uint64(a) + np.uint64(b)) & _MASK32)
            % np.uint64(width)).astype(np.int64)


def hash_sign(x: np.ndarray, c: int, d: int) -> np.ndarray:
    """±1 sign hash off the multiplier's top bit (count-sketch rows)."""
    x = np.asarray(x, np.uint64)
    top = ((x * np.uint64(c) + np.uint64(d)) & _MASK32) >> np.uint64(31)
    return 1 - 2 * top.astype(np.int64)


class _TableSketch:
    """Shared shell: a (depth, width) int64 counter table + hash rows."""

    salt = "cms"
    signed = False

    def __init__(self, width: int, depth: int, seed: int = 0):
        self.width = int(width)
        self.depth = int(depth)
        self.seed = int(seed)
        if self.width < 2 or self.depth < 1:
            raise ValueError(
                f"bad sketch geometry width={width} depth={depth}")
        self.a, self.b, self.c, self.d = hash_family(
            self.seed, self.depth, self.salt)
        self.table = np.zeros((self.depth, self.width), np.int64)

    # -- updates -----------------------------------------------------------
    def add(self, items: Iterable[Any],
            counts: Optional[Sequence[int]] = None) -> None:
        ids = np.asarray([item_to_u32(it) for it in items], np.uint64)
        if ids.size == 0:
            return
        cnt = (np.ones(ids.size, np.int64) if counts is None
               else np.asarray(counts, np.int64))
        for r in range(self.depth):
            cols = hash_bucket(ids, self.a[r], self.b[r], self.width)
            inc = cnt * (hash_sign(ids, self.c[r], self.d[r])
                         if self.signed else 1)
            np.add.at(self.table[r], cols, inc)

    # -- queries -----------------------------------------------------------
    def query(self, item: Any) -> int:
        x = np.asarray([item_to_u32(item)], np.uint64)
        ests = []
        for r in range(self.depth):
            col = int(hash_bucket(x, self.a[r], self.b[r], self.width)[0])
            v = int(self.table[r, col])
            if self.signed:
                v *= int(hash_sign(x, self.c[r], self.d[r])[0])
            ests.append(v)
        if self.signed:
            return int(np.median(ests))
        return int(min(ests))

    # -- merge algebra -----------------------------------------------------
    def merge(self, other: "_TableSketch") -> "_TableSketch":
        if (type(other) is not type(self)
                or other.table.shape != self.table.shape
                or other.seed != self.seed):
            raise ValueError(
                "cannot merge sketches with different geometry/seed: "
                f"{self!r} vs {other!r}")
        self.table += other.table
        return self

    # -- wire form ---------------------------------------------------------
    def leaves(self) -> Dict[str, np.ndarray]:
        """The sketch as a float32 pytree — integer counters, exactly
        representable (the wire enforces |count| < 2^23)."""
        return {"table": self.table.astype(np.float32)}

    def load_leaves(self, tree: Any) -> "_TableSketch":
        t = np.asarray(tree["table"] if isinstance(tree, dict) else tree)
        if t.shape != (self.depth, self.width):
            raise ValueError(
                f"sketch table shape {t.shape} does not match geometry "
                f"({self.depth}, {self.width})")
        self.table = np.rint(np.asarray(t, np.float64)).astype(np.int64)
        return self

    @property
    def epsilon(self) -> float:
        """Count-min additive error factor: overestimate ≤ ε·N with
        ε = e/width (probability ≥ 1 − e^−depth)."""
        return math.e / self.width

    def __repr__(self) -> str:  # pragma: no cover
        return (f"{type(self).__name__}(width={self.width}, "
                f"depth={self.depth}, seed={self.seed})")


class CountMinSketch(_TableSketch):
    salt = "cms"
    signed = False


class CountSketch(_TableSketch):
    salt = "csk"
    signed = True


class VoteVectorSketch(_TableSketch):
    """TrieHH prefix-extension votes as a count-min table.

    A client votes at trie level ``L`` for each of its words whose
    length-``L`` prefix extends a server-popular length-``L−1`` prefix
    (level 1 votes unconditionally — the trie root is always popular).
    Words carry the '$' terminator, like the plaintext analyzer, so a
    finished word surfaces as a votable prefix.
    """

    salt = "votevec"
    signed = False

    def vote(self, words: Iterable[str], popular: Iterable[str],
             level: int) -> None:
        level = int(level)
        pop = set(popular)
        ballots = []
        for w in words:
            w = str(w) + "$"
            if len(w) < level:
                continue
            prefix = w[:level]
            if level > 1 and prefix[:-1] not in pop:
                continue
            ballots.append(prefix)
        self.add(ballots)

    def read(self, candidates: Iterable[str]) -> Dict[str, int]:
        """Server side: point-query every candidate prefix's vote count."""
        return {c: self.query(c) for c in candidates}


class BloomSketch:
    """Counting Bloom vector for union / intersection / cardinality.

    A client's contribution is a 0/1 membership vector (``hashes``
    positions per distinct item, deduplicated, clamped to 1). After the
    federation SUMS n client vectors: ``cell > 0`` is the union filter,
    ``cell == n`` the intersection filter, and linear counting
    (Whang et al. 1990) turns either fill fraction into a cardinality
    estimate: ``n̂ = −(m/k)·ln(1 − X/m)``.
    """

    def __init__(self, bits: int, hashes: int, seed: int = 0):
        self.bits = int(bits)
        self.hashes = int(hashes)
        self.seed = int(seed)
        if self.bits < 8 or not (1 <= self.hashes <= 16):
            raise ValueError(
                f"bad bloom geometry bits={bits} hashes={hashes}")
        self.a, self.b, _, _ = hash_family(self.seed, self.hashes, "bloom")
        self.vector = np.zeros(self.bits, np.int64)

    def add(self, items: Iterable[Any]) -> None:
        ids = np.asarray(sorted({item_to_u32(it) for it in items}),
                         np.uint64)
        if ids.size == 0:
            return
        hit = np.zeros(self.bits, bool)
        for r in range(self.hashes):
            hit[hash_bucket(ids, self.a[r], self.b[r], self.bits)] = True
        self.vector = np.maximum(self.vector, hit.astype(np.int64))

    def contains(self, item: Any, threshold: int = 1) -> bool:
        x = np.asarray([item_to_u32(item)], np.uint64)
        for r in range(self.hashes):
            col = int(hash_bucket(x, self.a[r], self.b[r], self.bits)[0])
            if self.vector[col] < threshold:
                return False
        return True

    def merge(self, other: "BloomSketch") -> "BloomSketch":
        if (other.bits != self.bits or other.hashes != self.hashes
                or other.seed != self.seed):
            raise ValueError("cannot merge bloom sketches with different "
                             "geometry/seed")
        self.vector += other.vector
        return self

    def estimate_cardinality(self, threshold: int = 1) -> float:
        """Linear-counting estimate of items whose every cell ≥ threshold
        (threshold 1 = union; threshold n_clients = intersection)."""
        filled = int((self.vector >= max(1, int(threshold))).sum())
        if filled >= self.bits:  # saturated: estimate diverges
            return float("inf")
        frac = filled / float(self.bits)
        return -(self.bits / float(self.hashes)) * math.log1p(-frac)

    def leaves(self) -> Dict[str, np.ndarray]:
        return {"vector": self.vector.astype(np.float32)}

    def load_leaves(self, tree: Any) -> "BloomSketch":
        v = np.asarray(tree["vector"] if isinstance(tree, dict) else tree)
        if v.shape != (self.bits,):
            raise ValueError(
                f"bloom vector shape {v.shape} != ({self.bits},)")
        self.vector = np.rint(np.asarray(v, np.float64)).astype(np.int64)
        return self

    def __repr__(self) -> str:  # pragma: no cover
        return (f"BloomSketch(bits={self.bits}, hashes={self.hashes}, "
                f"seed={self.seed})")


def k_percentile_from_histogram(counts: np.ndarray, edges: np.ndarray,
                                k: float) -> float:
    """The k-th percentile value, linearly interpolated inside the
    first bin where the merged CDF crosses the target rank."""
    counts = np.asarray(counts, np.float64)
    edges = np.asarray(edges, np.float64)
    total = float(counts.sum())
    if total <= 0:
        raise ValueError("empty merged histogram: no percentile to read")
    rank = max(1.0, math.ceil(k / 100.0 * total))
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, rank))
    i = min(i, len(counts) - 1)
    prev = float(cum[i - 1]) if i > 0 else 0.0
    inside = max(float(counts[i]), 1.0)
    frac = min(1.0, max(0.0, (rank - prev) / inside))
    return float(edges[i] + frac * (edges[i + 1] - edges[i]))


class HistogramSketch:
    """Fixed-bin histogram over a preset [lo, hi) range.

    Unlike the plaintext two-round histogram task (range discovery then
    counts), the sketch form fixes the range up front so a single
    sum-mergeable counter vector carries the whole answer — and the
    quantile summary (:func:`k_percentile_from_histogram`) reads off the
    merged CDF with no extra round.
    """

    def __init__(self, lo: float, hi: float, bins: int):
        self.lo = float(lo)
        self.hi = float(hi)
        self.bins = int(bins)
        if not (self.hi > self.lo) or self.bins < 1:
            raise ValueError(
                f"bad histogram geometry lo={lo} hi={hi} bins={bins}")
        self.edges = np.linspace(self.lo, self.hi, self.bins + 1)
        self.counts = np.zeros(self.bins, np.int64)

    def add(self, values: Iterable[float]) -> None:
        arr = np.asarray(list(values), np.float64)
        if arr.size == 0:
            return
        # clamp out-of-range values into the edge bins: analytics over
        # phone telemetry must not silently drop the tails
        arr = np.clip(arr, self.lo, np.nextafter(self.hi, self.lo))
        c, _ = np.histogram(arr, bins=self.edges)
        self.counts += c.astype(np.int64)

    def merge(self, other: "HistogramSketch") -> "HistogramSketch":
        if (other.bins != self.bins or other.lo != self.lo
                or other.hi != self.hi):
            raise ValueError("cannot merge histograms with different "
                             "ranges/bins")
        self.counts += other.counts
        return self

    def quantile(self, k: float) -> float:
        return k_percentile_from_histogram(self.counts, self.edges, k)

    def leaves(self) -> Dict[str, np.ndarray]:
        return {"counts": self.counts.astype(np.float32)}

    def load_leaves(self, tree: Any) -> "HistogramSketch":
        c = np.asarray(tree["counts"] if isinstance(tree, dict) else tree)
        if c.shape != (self.bins,):
            raise ValueError(
                f"histogram counts shape {c.shape} != ({self.bins},)")
        self.counts = np.rint(np.asarray(c, np.float64)).astype(np.int64)
        return self

    def __repr__(self) -> str:  # pragma: no cover
        return (f"HistogramSketch(lo={self.lo:g}, hi={self.hi:g}, "
                f"bins={self.bins})")
