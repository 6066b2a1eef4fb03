"""Hierarchical sketch federation: 100k+ virtual clients on one device —
counterpart of ``fedml_tpu/fa/sketch/federation.py``.

This is the FA engine's scale path. Where the FSM in :mod:`fedml_tpu_torch.fa`
runs a real message-passing round over tens of clients,
:func:`run_sketch_federation` drives a TrieHH-style heavy-hitter vote
federation over the :class:`~fedml_tpu_torch.hierarchy.TreeRunner`
aggregation tree: every virtual client draws its seeded word stream and
folds it into a vote-vector table inside the leaf chunk's batched pass on
the run's device — a chunk's ``[C, depth, width]`` tables are one tensor
there, never a host array (:func:`last_sketch_trace`) — and the cohort
reduces through the same fused / SecAgg / durability stack model deltas
ride. Under SecAgg the edge only sees the masked cohort sum; with
``dp_sigma`` the root adds seeded Gaussian noise on the device before the
global lands (:func:`fedml_tpu_torch.hierarchy.runner.last_dp_trace`).

The tensor hash (:func:`hash_bucket`) reproduces the host family
(:func:`fedml_tpu_torch.fa.sketch.sketches.hash_bucket`) cell for cell, and
the word stream (:func:`make_word_stream`) draws the reference's words bit
for bit (``threefry.uniform_batch`` and ``randint_batch``), so the
federated heavy-hitter set is comparable with :func:`reference_sketch_counts`
on the same seeded data, and with the reference's.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.compression.codecs import derive_key_data_batch, get_codec
from fedml_tpu_torch.device import DeviceLike, resolve_device
from fedml_tpu_torch.fa.sketch.sketches import hash_bucket as host_hash_bucket
from fedml_tpu_torch.fa.sketch.sketches import hash_family
from fedml_tpu_torch.hierarchy.runner import TreeRunner
from fedml_tpu_torch.hierarchy.tree import TreeTopology

__all__ = [
    "hash_bucket",
    "last_sketch_trace",
    "make_vote_delta_fn",
    "make_word_stream",
    "reference_sketch_counts",
    "run_sketch_federation",
    "zcdp_epsilon",
]

_MASK32 = 0xFFFFFFFF

# the sketch probe, under the reference's key: True means each client's
# table existed only as a tensor on the run's device (in the chunk's batched
# table), never a host array that something could log or leak
_SKETCH_TRACE: Dict[str, Any] = {"client_sketch_traced": None}


def last_sketch_trace() -> Dict[str, Any]:
    return dict(_SKETCH_TRACE)


def zcdp_epsilon(sigma: float, sensitivity: float, rounds: int = 1,
                 delta: float = 1e-6) -> float:
    """(ε, δ)-DP spent by ``rounds`` Gaussian releases at noise std ``sigma``
    and per-client L2 sensitivity ``sensitivity``, accounted through zCDP:
    each release costs ρ = (s/σ)²/2, composition adds, and ρ-zCDP converts to
    ε = ρ + 2·sqrt(ρ·ln(1/δ))."""
    if sigma <= 0:
        return float("inf")
    rho = float(rounds) * (float(sensitivity) / float(sigma)) ** 2 / 2.0
    return rho + 2.0 * math.sqrt(rho * math.log(1.0 / float(delta)))


def hash_bucket(x: torch.Tensor, a: Any, b: Any, width: int) -> torch.Tensor:
    """``((x·a + b) mod 2^32) mod width`` on a tensor of uint32 values (in
    int64), the twin of the host family's and of the reference's
    ``jax_hash_bucket``. ``a`` and ``b`` are ints or int64 tensors that
    broadcast against ``x`` (one row's constants a row). ``x·a`` would
    overflow int64, so ``a`` is split into 16-bit halves and each product
    reduced mod 2^32 before the sum; returns int64 buckets."""
    x = x.to(torch.int64) & _MASK32
    a = a & _MASK32 if isinstance(a, torch.Tensor) else int(a) & _MASK32
    b = b & _MASK32 if isinstance(b, torch.Tensor) else int(b) & _MASK32
    lo = x * (a & 0xFFFF)                       # < 2^48
    hi = ((x * (a >> 16)) & 0xFFFF) << 16       # (x·a_hi mod 2^16)·2^16
    return ((lo + hi + b) & _MASK32) % int(width)


def make_word_stream(vocab: int, n_hot: int, p_hot: float,
                     words_per_client: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Seeded item generator: ``[C, 2]`` keys → ``[C, words]`` uint32 ids (in
    int64), row ``c`` the reference's ``gen_ids(keys[c])`` bit for bit.

    A two-tier popularity model: with probability ``p_hot`` a word is drawn
    from the hot head ``[0, n_hot)``, else uniformly from the whole
    vocabulary, so the ground-truth heavy-hitter set is the hot head,
    discoverable but not baked in."""
    vocab, n_hot = int(vocab), int(n_hot)
    words = int(words_per_client)
    p = float(np.float32(p_hot))  # the reference compares in f32

    def gen_ids(keys: torch.Tensor) -> torch.Tensor:
        ku, kh, kc = threefry.fold_in_many(keys, (11, 12, 13)).unbind(1)
        u = threefry.uniform_batch(ku, (words,))
        hot = threefry.randint_batch(kh, (words,), 0, n_hot)
        cold = threefry.randint_batch(kc, (words,), 0, vocab)
        return torch.where(u < p, hot, cold).to(torch.int64) & _MASK32

    return gen_ids


def make_vote_delta_fn(width: int, depth: int, hash_seed: int, salt: str,
                       gen_ids) -> Callable[[torch.Tensor], tuple]:
    """The leaf ``delta_fn``: a chunk's ``[C, 2]`` key data → its ``[C, depth,
    width]`` f32 vote tables, one ``bincount`` of the flat cell index
    ``(c·depth + r)·width + bucket`` (integer counts, no float atomics, the
    same in any order), over a ``{"table": (depth, width) f32}`` template."""
    a_rows, b_rows, _, _ = hash_family(int(hash_seed), int(depth), salt)
    width, depth = int(width), int(depth)

    def delta_fn(keys: torch.Tensor) -> tuple:
        dev = keys.device
        ids = gen_ids(keys)                                      # [C, words]
        c = ids.shape[0]
        a = torch.tensor(a_rows.astype(np.int64), device=dev)[None, :, None]
        b = torch.tensor(b_rows.astype(np.int64), device=dev)[None, :, None]
        cells = hash_bucket(ids[:, None, :], a, b, width)        # [C, depth, words]
        rows = torch.arange(c * depth, dtype=torch.int64, device=dev).reshape(c, depth, 1)
        flat = (rows * width + cells).reshape(-1)
        table = torch.bincount(flat, minlength=c * depth * width).reshape(
            c, depth, width).to(torch.float32)
        _SKETCH_TRACE["client_sketch_traced"] = (isinstance(table, torch.Tensor)
                                                 and table.device == dev)
        return (table,)

    return delta_fn


def reference_sketch_counts(seed: int, round_idx: int, client_ids: Sequence[int], gen_ids,
                            vocab: int, chunk: int = 8192,
                            device: DeviceLike = "cuda") -> np.ndarray:
    """Ground-truth per-word counts over ``client_ids``' seeded streams.

    Replays the leaf pass's exact key chain (``derive_key_data_batch``, then
    ``fold_in(key, 1)``: see ``hierarchy.edge.leaf_chunk``) on ``device``, so
    the plaintext reference sees the federated clients' item streams."""
    dev = resolve_device(device)
    counts = torch.zeros(int(vocab), dtype=torch.int64, device=dev)
    cids = np.asarray(sorted(int(c) for c in client_ids), np.int64)
    for lo in range(0, len(cids), int(chunk)):
        kd = derive_key_data_batch(int(seed), int(round_idx), cids[lo:lo + int(chunk)])
        keys = threefry.fold_in_batch(torch.from_numpy(kd.astype(np.int64)).to(dev), 1)
        counts += torch.bincount(gen_ids(keys).reshape(-1), minlength=int(vocab))
    return counts.cpu().numpy()


def _sketch_table_from_counts(counts: np.ndarray, a_rows, b_rows,
                              width: int, depth: int) -> np.ndarray:
    """The sketch a single global client holding ALL items would build —
    scatter the exact per-word counts through the same hash rows."""
    vocab = len(counts)
    ids = np.arange(vocab, dtype=np.uint64)
    table = np.zeros((int(depth), int(width)), np.int64)
    for r in range(int(depth)):
        idx = host_hash_bucket(ids, int(a_rows[r]), int(b_rows[r]), int(width))
        np.add.at(table[r], idx, counts)
    return table


def _read_min_rows(table: np.ndarray, a_rows, b_rows,
                   width: int, vocab: int) -> np.ndarray:
    """Point-query every vocab id: min over rows (count-min read)."""
    ids = np.arange(int(vocab), dtype=np.uint64)
    est = None
    for r in range(table.shape[0]):
        idx = host_hash_bucket(ids, int(a_rows[r]), int(b_rows[r]), int(width))
        row = table[r][idx]
        est = row if est is None else np.minimum(est, row)
    return est


def run_sketch_federation(
    n_clients: int = 4096,
    tiers: int = 3,
    codec: str = "votevec@4096/3",
    seed: int = 0,
    vocab: int = 512,
    n_hot: int = 12,
    p_hot: float = 0.5,
    words_per_client: int = 32,
    hh_threshold_frac: float = 0.02,
    levels: Optional[Sequence[int]] = None,
    quorum: float = 1.0,
    chunk: int = 2048,
    secagg: bool = False,
    secagg_mod_bits: int = 16,
    dp_sigma: float = 0.0,
    dp_delta: float = 1e-6,
    chaos: Optional[Sequence[Any]] = None,
    durability_dir: Optional[str] = None,
    reference_client_ids: Optional[Sequence[int]] = None,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """One-shot heavy-hitter federation over the aggregation tree on
    ``device``.

    Returns the federated heavy-hitter set next to the plaintext reference
    computed on the same seeded data, plus the runner's scenario stats
    (digest, rounds/s, per-tier bytes). ``chaos`` takes the runner's kill
    windows; under ``secagg`` the per-client clip is pinned to the cohort
    quant bound so integer votes survive the mask/unmask round trip exactly.
    ``reference_client_ids`` overrides the roster the plaintext reference
    replays (default every client: pass the survivors when chaos kills
    leaves).
    """
    from fedml_tpu_torch.telemetry import get_registry

    dev = resolve_device(device)
    c = get_codec(str(codec))
    width = int(getattr(c, "width"))
    depth = int(getattr(c, "depth"))
    salt = {"votevec": "votevec", "cms": "cms"}.get(c.name)
    if salt is None:
        raise ValueError(
            f"sketch federation needs an unsigned table codec "
            f"(cms/votevec), got {c.spec!r}")
    gen_ids = make_word_stream(vocab, n_hot, p_hot, words_per_client)
    delta_fn = make_vote_delta_fn(width, depth, seed, salt, gen_ids)
    template = {"table": np.zeros((depth, width), np.float32)}

    topo = TreeTopology(tuple(int(x) for x in levels)) if levels \
        else TreeTopology.build(int(n_clients), int(tiers))
    kw: Dict[str, Any] = {}
    if secagg:
        from fedml_tpu_torch.privacy.secagg import masking

        # uniform rosters keep one shared bound; clip == bound makes the
        # shared quant scale exactly 1.0, so integer votes pass through
        # floor(q + u) unchanged: masked == plain
        cohort_n = max(
            len(topo.children(topo.leaf_tier - 1, e))
            for e in range(topo.levels[topo.leaf_tier - 1]))
        kw.update(secagg=True, secagg_mod_bits=int(secagg_mod_bits),
                  secagg_clip=float(masking.client_bound(cohort_n, int(secagg_mod_bits))))
    runner = TreeRunner(
        topo, template=template, codec=c.spec, seed=int(seed),
        quorum=float(quorum), chunk=int(chunk), delta_fn=delta_fn,
        server_lr=1.0, chaos=chaos, durability_dir=durability_dir,
        dp_sigma=float(dp_sigma), device=dev, **kw)
    stats = runner.run(1)

    total_w = float(runner.last_root_weight)
    sum_table = np.rint(
        runner.global_leaves[0].cpu().double().numpy() * total_w).astype(np.int64)

    a_rows, b_rows, _, _ = hash_family(int(seed), depth, salt)
    total_words = total_w * float(words_per_client)
    threshold = max(1, int(math.ceil(float(hh_threshold_frac) * total_words)))
    est = _read_min_rows(sum_table, a_rows, b_rows, width, vocab)
    fed_hh = sorted(int(i) for i in np.nonzero(est >= threshold)[0])

    ref_ids = reference_client_ids if reference_client_ids is not None \
        else range(topo.n_clients)
    true_counts = reference_sketch_counts(seed, 0, ref_ids, gen_ids, vocab, device=dev)
    ref_table = _sketch_table_from_counts(true_counts, a_rows, b_rows, width, depth)
    ref_est = _read_min_rows(ref_table, a_rows, b_rows, width, vocab)
    ref_hh = sorted(int(i) for i in np.nonzero(ref_est >= threshold)[0])

    inter = len(set(fed_hh) & set(ref_hh))
    recall = inter / max(1, len(ref_hh))
    precision = inter / max(1, len(fed_hh))

    # L2 sensitivity of one client's vote table: ≤ words · sqrt(depth)
    # (each word lands in `depth` cells, worst case all words one cell)
    sensitivity = float(words_per_client) * math.sqrt(float(depth))
    epsilon = zcdp_epsilon(dp_sigma, sensitivity, rounds=1,
                           delta=dp_delta) if dp_sigma > 0 else 0.0
    reg = get_registry()
    reg.counter("fa/rounds", labels={"task": "heavy_hitter_federation"}).inc()
    if dp_sigma > 0:
        reg.gauge("fa/dp_epsilon").set(epsilon)
    reg.gauge("fa/hh_recall").set(recall)

    plain_sketch_bytes = 4 * depth * width  # int32 table, uncompressed
    return {
        "task": "heavy_hitter_federation",
        "spec": c.spec,
        "clients": topo.n_clients,
        "levels": list(topo.levels),
        "secagg": bool(secagg),
        "dp_sigma": float(dp_sigma),
        "dp_epsilon": epsilon,
        "threshold": threshold,
        "heavy_hitters": fed_hh,
        "ref_heavy_hitters": ref_hh,
        "hh_recall": recall,
        "hh_precision": precision,
        "root_total_weight": total_w,
        "per_client_wire_bytes": int(runner.per_client_wire_nbytes),
        "plain_sketch_bytes": plain_sketch_bytes,
        "wire_overhead": runner.per_client_wire_nbytes / float(plain_sketch_bytes),
        "rounds_per_s": stats["rounds_per_s"],
        "final_digest": stats["final_digest"],
        "stats": stats,
    }
