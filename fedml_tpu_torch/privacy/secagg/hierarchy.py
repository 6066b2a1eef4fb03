"""Per-edge-cohort SecAgg for the in-process aggregation tree — counterpart
of ``fedml_tpu/privacy/secagg/hierarchy.py``.

In a hierarchical federation the EDGE tier is the curious party: it
buffers its cohort's uploads, so without masking it sees every leaf
client's delta. :class:`SecAggLeafCohort` takes the
:class:`~fedml_tpu_torch.hierarchy.edge.LeafCohort` slot of a
:class:`~fedml_tpu_torch.hierarchy.runner.TreeRunner` and masks INSIDE the
cohort: each virtual client quantizes with the cohort-shared scale and adds
its pairwise masks in the same batched chunk pass, the edge sums masked
words mod ``2^k``, and only the cohort SUM is unmasked — the edge re-encodes
that mean for its uplink, so no tier holds a leaf delta. Chaos kills
recover as the cross-silo path does: the surviving pairs' seeds reproduce
the evicted clients' dangling mask halves, subtracted from the cohort sum.

The masks are the reference's host numpy (``masking.net_mask_leaves``, a
Philox stream a pair), and the pair seeds come from the tree seed by the
reference's blake2b derivation (both ends of a virtual pair live in this
process), so the masked cohort sums equal the JAX package's word for word.
Words are summed in int64 on the device and wrapped with ``& (2^k - 1)``.
"""
from __future__ import annotations

import hashlib
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.compression.codecs import _numel
from fedml_tpu_torch.hierarchy.edge import LeafCohort
from fedml_tpu_torch.privacy.secagg import masking
from fedml_tpu_torch.telemetry.profiling import wrap_program

__all__ = ["SecAggLeafCohort", "secagg_leaf_chunk"]

_WORD_BITS = (8, 16)


def _f32(x: float) -> float:
    return float(np.float32(x))


def secagg_leaf_chunk(meta, delta_fn, clip: float, bound: int, mod_bits: int,
                      keys: torch.Tensor, alive: torch.Tensor,
                      masks: Optional[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
    """generate → clip → shared-scale quant → +mask → masked SUM, one chunk
    at once on the keys' device. ``alive`` ``[C]`` zeroes dead and padded
    rows (their mask halves never arrived); ``masks`` one ``[C, *shape]``
    integer tensor a leaf, or None for zero masks. Returns one int64 tensor
    of words in ``[0, 2^k)`` a leaf: the chunk's masked sum mod ``2^k``.

    The scale is the reference program's constant, and its division is a
    product with the f32 reciprocal, as XLA compiles a division by a
    constant."""
    scale = _f32(clip / float(bound))
    inv_scale = _f32(np.float32(1.0) / np.float32(scale))
    wrap = (1 << mod_bits) - 1
    ids = list(range(len(meta)))
    sizes = [_numel(sh) for _, sh in meta]
    with torch.no_grad():
        delta_keys, enc_keys = threefry.fold_in_many(keys, (1, 2)).unbind(1)
        leaves = tuple(delta_fn(delta_keys))
        u = threefry.uniform_leaves(enc_keys, ids, sizes)
        a = alive.to(torch.int64)
        out, off = [], 0
        for i, (x, (_, sh)) in enumerate(zip(leaves, meta)):
            n = sizes[i]
            xc = torch.clamp(x.float().reshape(x.shape[0], -1), -clip, clip)
            q = torch.clamp(torch.floor(xc * inv_scale + u[:, off:off + n]), -bound, bound)
            off += n
            y = q.to(torch.int32)
            if masks is not None:
                y = (y + masks[i].reshape(y.shape).to(torch.int32)) & wrap
            else:
                y = y & wrap
            s = (y.to(torch.int64) * a[:, None]).sum(0) & wrap
            out.append(s.reshape(tuple(sh)))
        return out


# cataloged (telemetry.profiling) under the reference's name: one variant
# per chunk bucket by design
secagg_leaf_chunk = wrap_program("secagg/leaf_chunk", secagg_leaf_chunk,
                                 static_argnums=(0, 1, 2, 3, 4), multi_shape=True)


class SecAggLeafCohort(LeafCohort):
    """A leaf cohort whose edge only ever sees the masked sum.

    Same reduce contract as :class:`LeafCohort` (unnormalized f32 sum leaves
    + total weight), with per-client contributions pairwise-masked in the
    cohort-shared integer domain. Weights are uniform (masked sums are
    unweighted by construction) and EF is refused (no per-client decode to
    feed it). ``mod_bits`` is 8 or 16, the reference's word widths here.
    ``last_words`` holds the last round's unmasked cohort sum (int64 words
    mod ``2^k``, one tensor a leaf); ``host_mask_s`` the host seconds spent
    on masks and recovery so far.
    """

    def __init__(self, tier: int, edge_id: int, client_ids, codec, meta, delta_fn,
                 seed: int, chunk: int = 2048, clip: float = 0.1, mod_bits: int = 8, **kw):
        if kw.pop("ef", False):
            raise ValueError("secagg leaf cohorts do not support per-client error feedback "
                             "(there is no per-client decode to feed it)")
        if kw.pop("weights", None) is not None:
            raise ValueError("secagg leaf cohorts are uniform-weight by construction")
        if int(mod_bits) not in _WORD_BITS:
            raise ValueError(f"secagg leaf cohorts take mod_bits in {_WORD_BITS}, "
                             f"got {mod_bits}")
        super().__init__(tier, edge_id, client_ids, codec, meta, delta_fn, seed,
                         chunk=chunk, ef=False, **kw)
        self.clip = float(clip)
        self.mod_bits = int(mod_bits)
        # the shared quant bound is sized for the FULL roster: the mask
        # domain must absorb the worst-case cohort sum across kill rounds
        self.bound = masking.client_bound(len(self.client_ids), self.mod_bits)
        self._pair_secret_cache: dict = {}
        self.last_words: Optional[List[torch.Tensor]] = None
        self.host_mask_s = 0.0

    # -- deterministic in-process pair seeds --------------------------------
    def _pair_secret(self, i: int, j: int) -> int:
        lo, hi = (int(i), int(j)) if i < j else (int(j), int(i))
        if (lo, hi) not in self._pair_secret_cache:
            h = hashlib.blake2b(b"fedml_tpu/secagg/hier%d/%d/%d/%d" % (
                self.seed, self.edge_id, lo, hi), digest_size=16)
            self._pair_secret_cache[(lo, hi)] = int.from_bytes(h.digest(), "little")
        return self._pair_secret_cache[(lo, hi)]

    def _seeds_for(self, i: int, others, round_idx: int) -> dict:
        return {int(j): masking.pair_round_seed(self._pair_secret(i, j), round_idx)
                for j in others if int(j) != int(i)}

    def chunk_words(self, round_idx: int, idx: np.ndarray,
                    masks: Optional[Sequence[torch.Tensor]]) -> List[torch.Tensor]:
        """The masked word sum of the local clients ``idx`` (at most one
        chunk), padded to the chunk's bucket; ``masks`` None sums the same
        clipped, quantized words unmasked."""
        pad = self.chunk - len(idx)
        cids = np.concatenate([self.client_ids[idx], np.zeros(pad, np.int64)])
        keys = self._chunk_keys(round_idx, cids)
        alive = torch.cat([torch.ones(len(idx), dtype=torch.int64),
                           torch.zeros(pad, dtype=torch.int64)]).to(self.device)
        return secagg_leaf_chunk(self.meta, self.delta_fn, self.clip, self.bound,
                                 self.mod_bits, keys, alive, masks)

    def _chunk_masks(self, idx: np.ndarray, expected, round_idx: int) -> List[torch.Tensor]:
        t0 = time.perf_counter()
        rows = [masking.net_mask_leaves(int(i), self._seeds_for(int(i), expected, round_idx),
                                        self.meta, self.mod_bits) for i in idx]
        # padded rows carry zero masks; 8-bit words cross to the device as bytes
        dtype = np.uint8 if self.mod_bits == 8 else np.int32
        stacked = []
        for li, (_, sh) in enumerate(self.meta):
            words = np.zeros((self.chunk,) + tuple(sh), dtype)
            for c, m in enumerate(rows):
                words[c] = m[li]
            stacked.append(torch.from_numpy(words).to(self.device))
        self.host_mask_s += time.perf_counter() - t0
        return stacked

    def reduce(self, round_idx: int, alive_local: np.ndarray) -> Tuple[
            Optional[list], float, int]:
        from fedml_tpu_torch.telemetry import get_registry

        live = np.asarray(alive_local, bool) & ~self.evicted_mask
        expected = np.nonzero(~self.evicted_mask)[0]
        n_recv = int(live.sum())
        if n_recv == 0:
            return None, 0.0, 0
        # every EXPECTED client derived masks over the full expected roster;
        # dead-but-expected clients are the recovery set
        dead_expected = [int(i) for i in expected if not live[i]]
        live_idx = np.nonzero(live)[0]
        wrap = (1 << self.mod_bits) - 1
        total = None
        for start in range(0, len(live_idx), self.chunk):
            idx = live_idx[start:start + self.chunk]
            summed = self.chunk_words(round_idx, idx,
                                      self._chunk_masks(idx, expected, round_idx))
            total = summed if total is None else [(a + b) & wrap
                                                  for a, b in zip(total, summed)]
        # dropout recovery: reproduce the live↔dead halves and strip them
        if dead_expected:
            t0 = time.perf_counter()
            pairs = [(int(i), j, self._seeds_for(int(i), [j], round_idx)[j])
                     for i in live_idx for j in dead_expected]
            rec = masking.recovery_adjustment(pairs, self.meta, self.mod_bits)
            total = [(a - torch.from_numpy(r.astype(np.int64)).to(self.device)) & wrap
                     for a, r in zip(total, rec)]
            self.host_mask_s += time.perf_counter() - t0
            get_registry().counter("secagg/hier_recoveries").inc()
        get_registry().counter("secagg/hier_cohort_rounds").inc()
        self.last_words = total
        # re-center mod 2^k and scale: the cohort's unnormalized f32 sum
        half = 1 << (self.mod_bits - 1)
        scale = self.clip / float(self.bound)
        sum_leaves = [(s - ((s >= half).to(torch.int64) << self.mod_bits)).float() * scale
                      for s in total]
        return sum_leaves, float(n_recv), n_recv
