"""Ring 1 — admission screening in the compressed domain; counterpart of
``fedml_tpu/integrity/screen.py``.

Every upload is reduced to two facts on its own device in one pass, with
one device-to-host read (:func:`screen_stats`): *is every block and scale
finite*, and *what is each leaf's squared norm* — ``scale²·Σq²`` straight
off the int8 blocks, the kept values for top-k, ``Σ_b scale_b²·Σ_k v_bk²``
for int4 and nf4 — so no per-client f32 tree is built. The host then
applies the reference's three rules (:class:`UpdateScreen`):

- **non-finite**: any NaN/Inf block, scale or leaf → dropped outright;
- **norm overflow**: the upload's norm exceeds ``norm_mult ×`` the median
  of previously accepted upload norms (armed after 4 accepted uploads);
- **per-block robust z** (at round close): median/MAD z of each leaf's
  norm across the round's cohort, high side only, with a 20% relative
  floor on the scale and a 3× ratio condition.

Flagged uploads are dropped and counted (``integrity/*``), and the caller
quarantines their senders. A masked secure-aggregation upload cannot be
screened (per-upload introspection is what the masks prevent): it raises.
"""
from __future__ import annotations

import logging
import math
import threading
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fedml_tpu_torch.compression.codecs import (
    CompressedTree,
    _is_float_meta,
    _tree_meta,
    get_codec,
    tree_delta,
)
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.tree import Tree, tree_flatten

logger = logging.getLogger(__name__)

__all__ = ["ScreenStats", "UpdateScreen", "leaf_sqnorms", "screen_stats"]


def median(vals: Sequence[float]) -> float:
    """The host median of the reference's health module: the mean of the
    two middle values for an even count."""
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def _f32(p: Any) -> torch.Tensor:
    return torch.as_tensor(p).float()


def _part_finite(p: Any) -> torch.Tensor:
    t = torch.as_tensor(p)
    if t.is_floating_point():
        return torch.isfinite(t.float()).all()
    return torch.ones((), dtype=torch.bool, device=t.device)


def leaf_sqnorms(codec_name: Optional[str], meta, arrays
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(all_finite, per-leaf squared norms)`` of a wire tree's arrays (or
    of a plain tree's leaves, ``((leaf,), ...)`` with ``codec_name=None``),
    both left on the arrays' device. The int8 branch never decodes."""
    finite = None
    sq: List[torch.Tensor] = []
    for parts, (dt, shape) in zip(arrays, meta):
        for p in parts:
            f = _part_finite(p)
            finite = f if finite is None else finite & f.to(finite.device)
        if not _is_float_meta(dt) or codec_name in (None, "identity", "bf16", "topk"):
            # ints ride raw; top-k's kept values carry the whole mass
            sq.append(torch.sum(torch.square(_f32(parts[0]))))
        elif codec_name == "int8":
            q, scale = parts
            sq.append(torch.square(_f32(scale)) * torch.sum(torch.square(_f32(q))))
        elif codec_name in ("int4", "nf4"):
            # block-size independent; padding decodes to exact zero
            packed, scale = parts
            c4 = get_codec(codec_name)
            vals = c4._lookup(c4._unpack(torch.as_tensor(packed)))
            sq.append(torch.sum(torch.square(_f32(scale))
                                * torch.sum(torch.square(vals), -1)))
        else:  # a third-party codec: decode this leaf only
            parts_t = [torch.as_tensor(p) for p in parts]
            leaf = get_codec(codec_name).decode_leaf(parts_t, dt, shape)
            sq.append(torch.sum(torch.square(leaf.float())))
    dev = sq[0].device if sq else torch.device("cpu")
    if finite is None:
        finite = torch.ones((), dtype=torch.bool, device=dev)
    return finite.to(dev), torch.stack([s.to(dev) for s in sq]) if sq else \
        torch.zeros(0, device=dev)


class ScreenStats:
    """One upload's screen facts (the single device-to-host read)."""

    __slots__ = ("finite", "norm", "leaf_norms")

    def __init__(self, finite: bool, norm: float, leaf_norms: np.ndarray):
        self.finite = bool(finite)
        self.norm = float(norm)
        self.leaf_norms = np.asarray(leaf_norms, np.float64)


def screen_stats(payload: Any, base: Optional[Tree] = None) -> ScreenStats:
    """Screen facts for one upload — compressed or plain. ``CompressedTree``
    deltas are screened off their wire arrays; a plain tree as
    ``payload − base`` (or raw without a base)."""
    if isinstance(payload, CompressedTree):
        codec = get_codec(payload.codec)
        if getattr(codec, "maskable", False):
            raise ValueError(
                "masked (secure-aggregation) uploads cannot be screened — "
                "per-client introspection is what the masks exist to prevent")
        if not payload.is_delta and base is not None:
            # a compressed FULL model: the displacement only exists decoded
            return screen_stats(codec.decode(payload), base=base)
        finite, sq = leaf_sqnorms(payload.codec, payload.meta, payload.arrays)
    else:
        tree = tree_delta(payload, base) if base is not None else payload
        leaves, _ = tree_flatten(tree)
        finite, sq = leaf_sqnorms(None, _tree_meta(leaves),
                                  [(leaf,) for leaf in leaves])
    host = torch.cat([finite.reshape(1).to(sq.dtype), sq]).cpu().double().numpy()
    ok, sq = bool(host[0]), host[1:]
    total = float(np.sqrt(np.sum(sq))) if np.all(np.isfinite(sq)) else float("nan")
    return ScreenStats(ok, total, np.sqrt(np.maximum(sq, 0.0)))


class UpdateScreen:
    """Per-round admission screen and cohort outlier close: :meth:`admit`
    as uploads arrive, :meth:`close_round` once the cohort is in.
    Thread-safe (a receive thread admits while a timer thread closes)."""

    def __init__(self, norm_mult: float = 10.0, z_threshold: float = 8.0,
                 norm_history: int = 256, registry=None):
        self.norm_mult = float(norm_mult)
        self.z_threshold = float(z_threshold)
        self._reg = registry or get_registry()
        self._lock = threading.Lock()
        # accepted-upload norms across rounds: the overflow baseline
        self._norm_hist: deque = deque(maxlen=int(norm_history))
        # round -> client -> ScreenStats of admitted uploads
        self._pending: Dict[int, Dict[Any, ScreenStats]] = {}
        self.last_round_stats: Dict[Any, ScreenStats] = {}

    def _flag(self, counter: str, client: Any, round_idx: int, reason: str) -> str:
        self._reg.counter("integrity/screened_uploads").inc()
        self._reg.counter(counter).inc()
        logger.warning("upload of client %s screened at round %d: %s",
                       client, round_idx, reason)
        return reason

    def admit(self, client: Any, round_idx: int, payload: Any,
              base: Optional[Tree] = None) -> Optional[str]:
        """Screen one upload on arrival: the reason to DROP it, or None."""
        try:
            stats = screen_stats(payload, base=base)
        except ValueError as e:
            if "non-finite" in str(e):
                # the decode-side wire guard tripped first (a non-delta
                # payload decodes for its displacement norm)
                return self._flag("integrity/nonfinite_uploads", client,
                                  round_idx, str(e))
            raise  # the masked refusal: a misconfiguration
        if not stats.finite or not math.isfinite(stats.norm):
            return self._flag("integrity/nonfinite_uploads", client, round_idx,
                              "non-finite blocks or scales")
        with self._lock:
            hist = list(self._norm_hist)
        if len(hist) >= 4:
            med = median(hist)
            if med > 0 and stats.norm > self.norm_mult * med:
                return self._flag(
                    "integrity/norm_overflows", client, round_idx,
                    f"norm {stats.norm:.3g} > {self.norm_mult:g}x cohort "
                    f"median {med:.3g}")
        with self._lock:
            self._pending.setdefault(int(round_idx), {})[client] = stats
        return None

    def drop(self, client: Any, round_idx: int) -> None:
        """Forget an admitted upload the caller dropped for its own reasons."""
        with self._lock:
            self._pending.get(int(round_idx), {}).pop(client, None)

    def _screen_z(self, values: Dict[Any, float]) -> Dict[Any, float]:
        """High-side robust z: the MAD scale floored at 20% of the median,
        and only values above 3× the median count."""
        if len(values) < 4:
            return {}
        vals = list(values.values())
        med = median(vals)
        if med <= 0:
            # a frozen block: no cohort envelope to be an outlier of
            return {}
        mad = median([abs(v - med) for v in vals])
        scale = max(1.4826 * mad, 0.2 * abs(med), 1e-12)
        return {k: (v - med) / scale for k, v in values.items() if v > 3.0 * med}

    def close_round(self, round_idx: int) -> Dict[Any, str]:
        """The per-block robust-z pass over the round's admitted cohort:
        ``{client: reason}`` of uploads to drop. Accepted norms enter the
        overflow baseline."""
        with self._lock:
            cohort = self._pending.pop(int(round_idx), {})
        flagged: Dict[Any, str] = {}
        if len(cohort) >= 4:
            n_leaves = min(len(s.leaf_norms) for s in cohort.values())
            worst: Dict[Any, Tuple[float, int]] = {c: (0.0, -1) for c in cohort}
            for j in range(n_leaves):
                zs = self._screen_z({c: float(s.leaf_norms[j])
                                     for c, s in cohort.items()})
                for c, z in zs.items():
                    if abs(z) > worst[c][0]:
                        worst[c] = (abs(z), j)
            for c, (z, j) in worst.items():
                if z >= self.z_threshold:
                    flagged[c] = self._flag(
                        "integrity/z_outliers", c, round_idx,
                        f"block {j} robust z {z:.1f} >= {self.z_threshold:g}")
        accepted = {c: s for c, s in cohort.items() if c not in flagged}
        with self._lock:
            for s in accepted.values():
                self._norm_hist.append(s.norm)
            self.last_round_stats = accepted
        return flagged

    def suspects(self) -> List[Any]:
        """The last accepted round's distinguished suspects, most
        suspicious first: norms above 2× the cohort median, else the single
        largest update."""
        with self._lock:
            stats = dict(self.last_round_stats)
        if not stats:
            return []
        norms = {c: s.norm for c, s in stats.items()}
        med = median(list(norms.values()))
        out = [c for c, n in norms.items() if n > 2.0 * med]
        if not out:
            out = [max(norms, key=lambda c: norms[c])]
        return sorted(out, key=lambda c: -norms[c])
