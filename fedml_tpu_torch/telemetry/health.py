"""The compression-aware update norm of ``fedml_tpu/telemetry/health.py``
(:func:`update_norm`), which the norm-only defense's fused clip factors
read. The per-client health tracker and its ``health.jsonl`` are the
telemetry stack's (ROADMAP A12)."""
from __future__ import annotations

import math
from typing import Any, Optional

import torch

from fedml_tpu_torch.utils.tree import Tree, tree_flatten


def _tree_sq(tree: Tree, ref: Optional[Tree] = None) -> torch.Tensor:
    """Σ‖leaf − ref‖² accumulated on the leaves' device (no per-leaf sync)."""
    leaves, keys = tree_flatten(tree)
    total = None
    for a, k in zip(leaves, keys):
        a = a.float()
        if ref is not None:
            a = a - ref[k].float()
        s = torch.sum(torch.square(a))
        total = s if total is None else total + s.to(total.device)
    return total if total is not None else torch.zeros(())


def update_norm(update: Any, base: Optional[Tree] = None) -> Optional[float]:
    """L2 norm of a client update, compression-aware:

    - a ``CompressedTree`` delta: read off the wire arrays (int8 as
      ``scale²·Σq²``, top-k values, 4-bit blocks × scales), no full decode;
    - a ``CompressedTree`` full model: decoded, then diffed against ``base``;
    - a plain tree: ``‖update − base‖`` (``‖update‖`` without a base).

    One device-to-host read. None for a masked (secure-aggregation) upload,
    which the server must not introspect."""
    from fedml_tpu_torch.compression.codecs import CompressedTree, get_codec
    from fedml_tpu_torch.integrity.screen import leaf_sqnorms

    if isinstance(update, CompressedTree):
        codec = get_codec(update.codec)
        if codec is None or getattr(codec, "maskable", False):
            return None
        if not update.is_delta:
            return math.sqrt(float(_tree_sq(codec.decode(update), base)))
        _, sq = leaf_sqnorms(update.codec, update.meta, update.arrays)
        return math.sqrt(float(torch.sum(sq)))
    return math.sqrt(float(_tree_sq(update, base)))


__all__ = ["update_norm"]
