"""The ``health.jsonl`` sink and the compression-aware update norm of
``fedml_tpu/telemetry/health.py``: :func:`log_health_event` (the device
stats sampler's ``mem_sample`` records go through it) and
:func:`update_norm`, which the norm-only defense's fused clip factors
read. The per-client health tracker and its ``client_health`` records are
the run-health slice's (ROADMAP A12b2)."""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Any, Dict, Optional

import torch

from fedml_tpu_torch.utils.tree import Tree, tree_flatten

HEALTH_FILENAME = "health.jsonl"

_log_lock = threading.Lock()
_log_fh = None
_log_path: Optional[str] = None


def _sink_dir() -> Optional[str]:
    from fedml_tpu_torch.telemetry.spans import get_tracer

    return get_tracer().sink_dir


def log_health_event(rec: Dict[str, Any]) -> None:
    """Append one event to ``<run_dir>/health.jsonl`` (write-through, so a
    crashed run keeps everything up to its last event). No-op until the
    tracer is bound to a run dir; the flight recorder still sees the
    event either way."""
    global _log_fh, _log_path
    run_dir = _sink_dir()
    if run_dir is None:
        return
    rec = {"ts": rec.get("ts", time.time()), **rec}
    path = os.path.join(run_dir, HEALTH_FILENAME)
    with _log_lock:
        if _log_fh is None or _log_path != path or not os.path.exists(path):
            if _log_fh is not None:
                try:
                    _log_fh.close()
                except OSError:
                    pass
            os.makedirs(run_dir, exist_ok=True)
            _log_fh = open(path, "a")
            _log_path = path
        _log_fh.write(json.dumps(rec, default=str) + "\n")
        _log_fh.flush()


def reset_health_log() -> None:
    """Drop the cached append handle (test isolation)."""
    global _log_fh, _log_path
    with _log_lock:
        if _log_fh is not None:
            try:
                _log_fh.close()
            except OSError:
                pass
        _log_fh = None
        _log_path = None


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


__all__ = ["HEALTH_FILENAME", "log_health_event", "reset_health_log", "update_norm"]
