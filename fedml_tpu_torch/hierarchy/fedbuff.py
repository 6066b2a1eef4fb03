"""Buffered asynchronous aggregation (FedBuff, Nguyen et al. 2022) —
counterpart of ``fedml_tpu/hierarchy/fedbuff.py``.

The server collects K delta contributions, each tagged with the model
version it was trained against, and applies them in one step,

    x ← x + η · Σᵢ wᵢ·Δᵢ / Σᵢ wᵢ,     wᵢ = nᵢ · s(τᵢ),  s(τ) = (1+τ)^(-a)

where τᵢ is the contribution's staleness (server versions advanced since
its base) and ``a = 0.5`` gives the paper's ``1/sqrt(1+τ)``. At τ = 0 the
weight is the plain sample count, so a buffer of fresh contributions is
exactly a synchronous FedAvg step.

The flush sorts the contributions by ``(base_version, sender, seq)`` before
the reduction, so the order the transport delivered them in cannot change
the aggregate: the same set flushes to the same bits. Compressed deltas
reduce through the dequant-fused weighted sum
(``compression.fused_weighted_sum``), with no per-contributor f32 tree.
Trees are the port's flat dicts; the buffer adds and returns whatever
layout its payloads and ``global_params`` share (the async server keeps
the reference's, which compressed trees carry).
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression import CompressedTree, get_codec
from fedml_tpu_torch.compression.codecs import fused_weighted_sum, tree_delta, tree_undelta
from fedml_tpu_torch.utils.tree import Tree

__all__ = ["FedBuffBuffer", "staleness_weight"]


def staleness_weight(tau: float, exponent: float = 0.5) -> float:
    """The polynomial staleness discount ``(1+τ)^(-exponent)``: 1.0 for a
    fresh contribution, decaying monotonically."""
    return float((1.0 + max(0.0, float(tau))) ** (-float(exponent)))


class _Entry:
    __slots__ = ("sender", "base_version", "n_samples", "payload", "seq")

    def __init__(self, sender, base_version, n_samples, payload, seq):
        self.sender = int(sender)
        self.base_version = int(base_version)
        self.n_samples = float(n_samples)
        self.payload = payload
        self.seq = int(seq)


class FedBuffBuffer:
    """A bounded buffer of delta contributions: delta-encoded
    ``CompressedTree``s (the compressed transport's upload) or plain full
    model trees (compression off), which become deltas against the current
    global at the flush, so a τ=0 full-buffer flush is a synchronous FedAvg
    round either way."""

    def __init__(self, capacity: int, staleness_exponent: float = 0.5):
        self.capacity = max(1, int(capacity))
        self.staleness_exponent = float(staleness_exponent)
        self._entries: List[_Entry] = []
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def full(self) -> bool:
        return len(self._entries) >= self.capacity

    def add(self, sender: int, base_version: int, n_samples: float, payload: Any) -> None:
        if self.full:
            raise RuntimeError(f"FedBuff buffer overflow (capacity {self.capacity}); "
                               "flush before adding")
        if isinstance(payload, CompressedTree) and not payload.is_delta:
            raise ValueError("FedBuff buffers delta contributions; got a compressed FULL "
                             "model (decode it first or enable delta uploads)")
        self._entries.append(_Entry(sender, base_version, n_samples, payload,
                                    next(self._seq)))

    def flush(self, current_version: int, global_params: Tree) -> Tuple[Tree, Dict]:
        """Apply the buffer: ``(new_global, stats)``. Compressed entries of
        one codec reduce through the fused weighted sum; plain entries
        deltify against ``global_params`` and reduce in f32 in the same
        canonical order; a mixed buffer decodes its compressed entries."""
        if not self._entries:
            raise RuntimeError("flush of an empty FedBuff buffer")
        entries = sorted(self._entries, key=lambda e: (e.base_version, e.sender, e.seq))
        self._entries = []
        stale = [max(0, int(current_version) - e.base_version) for e in entries]
        weights = np.asarray([e.n_samples * staleness_weight(t, self.staleness_exponent)
                              for e, t in zip(entries, stale)], np.float64)
        total = float(weights.sum())
        if total <= 0:
            weights = np.ones(len(entries), np.float64)
            total = float(len(entries))
        w = (weights / total).astype(np.float32)

        payloads = [e.payload for e in entries]
        if (all(isinstance(p, CompressedTree) for p in payloads)
                and len({p.codec for p in payloads}) == 1):
            mean_delta = fused_weighted_sum(payloads, w)
        else:
            deltas = [get_codec(p.codec).decode(p) if isinstance(p, CompressedTree)
                      else tree_delta(p, global_params) for p in payloads]
            mean_delta = {k: float(w[0]) * d.to(torch.float32) for k, d in deltas[0].items()}
            for wi, d in zip(w[1:], deltas[1:]):
                mean_delta = {k: acc + float(wi) * d[k].to(torch.float32)
                              for k, acc in mean_delta.items()}
            mean_delta = {k: acc.to(global_params[k].dtype)
                          for k, acc in mean_delta.items()}
        new_global = tree_undelta(global_params, mean_delta)
        stats = {
            "flushed": len(entries),
            "staleness": stale,
            "mean_staleness": float(sum(stale)) / len(stale),
            "senders": [e.sender for e in entries],
            "weights": [float(x) for x in w],
        }
        return new_global, stats
