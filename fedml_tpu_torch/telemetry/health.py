"""Per-client run health — the port's ``fedml_tpu/telemetry/health.py``.

Straggler and anomaly scoring while training, computed by the server from
signals the federation already carries (no new message round trips):

- **round latency** per client (broadcast to upload, or the sp loop's
  per-client train wall): each round scores a client as ``latency / cohort
  median``, and the straggler flag fires on the MEDIAN of those per-round
  scores, so one compile-heavy round 0 cannot brand a client (the latency
  EWMA is kept too: the smoothed latency the adaptive deadline reads);
- **update norm** of each client's delta against the round's broadcast
  base, read off the compressed blocks when the upload is compressed
  (:func:`update_norm`), so a noise-injected client stands out under a
  lossy codec too; a masked (SecAgg) upload has none, by design;
- **train loss**, when the upload or the trainer carries one as a number.

Norms and losses are scored per round with a robust z (median/MAD over the
round's cohort, cohorts of at least 4); a client's anomaly score is the
median of its per-round max-|z| values, and a flag needs ``min_rounds``
scored rounds. The scoring is plain Python floats. Scores land three ways:
``health/*`` gauges (labelled by client), one ``client_health`` record a
client a round in ``<run_dir>/health.jsonl`` (the reference's keys, so
either package's doctor reads either package's file), and a ``health_flag``
flight-recorder record for a flagged client.
"""
from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

import torch

from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.registry import get_registry
from fedml_tpu_torch.utils.tree import Tree, tree_flatten

logger = logging.getLogger(__name__)

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


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_z(values: Dict[Any, float]) -> Dict[Any, float]:
    """Median/MAD z-score per key; {} when the cohort is too small for a
    meaningful spread. n < 4 is degenerate: with three values the MAD is
    the smaller of two deviations, so any spread between two honest clients
    explodes the third's z."""
    if len(values) < 4:
        return {}
    vals = list(values.values())
    med = _median(vals)
    mad = _median([abs(v - med) for v in vals])
    scale = 1.4826 * mad
    if scale <= 0:
        # a degenerate cohort (ties): the mean absolute deviation instead
        scale = sum(abs(v - med) for v in vals) / len(vals) or 1e-12
    return {k: (v - med) / scale for k, v in values.items()}


class ClientHealthTracker:
    """The server's per-client health state machine.

    Drive it with :meth:`observe` as uploads arrive, then
    :meth:`finish_round` once the round's cohort is complete, when the
    cross-client z-scores are computable. Thread-safe: the cross-silo
    handlers run on the comm receive thread and the deadline timers."""

    def __init__(self, registry=None, ewma_alpha: float = 0.4,
                 straggler_threshold: float = 2.0,
                 anomaly_threshold: float = 4.0,
                 min_rounds: int = 3,
                 heartbeat_window_s: float = 300.0):
        self._reg = registry or get_registry()
        self.ewma_alpha = float(ewma_alpha)
        self.straggler_threshold = float(straggler_threshold)
        self.anomaly_threshold = float(anomaly_threshold)
        self.min_rounds = int(min_rounds)
        self.heartbeat_window_s = float(heartbeat_window_s)
        self._lock = threading.Lock()
        self._pending: Dict[int, Dict[Any, Dict]] = {}
        self.latency_ewma: Dict[Any, float] = {}
        # per-round score histories, newest last (bounded); a client's
        # scores are the MEDIANS of these
        self._score_hist: Dict[Any, deque] = {}
        self._z_hist: Dict[Any, deque] = {}
        self.last_seen: Dict[Any, float] = {}
        self.rounds_scored = 0

    def straggler_score(self, client_id: Any) -> float:
        """Median of the client's per-round latency / cohort-median scores
        (1.0 until a latency is observed)."""
        with self._lock:
            hist = self._score_hist.get(client_id)
            return _median(list(hist)) if hist else 1.0

    def anomaly_score(self, client_id: Any) -> float:
        """Median of the client's per-round max-|z| values."""
        with self._lock:
            hist = self._z_hist.get(client_id)
            return _median(list(hist)) if hist else 0.0

    # -- inputs ---------------------------------------------------------------
    def heartbeat(self, client_id: Any, fields: Optional[Dict] = None) -> None:
        """A liveness ping piggybacked on an existing message header."""
        now = time.time()
        with self._lock:
            self.last_seen[client_id] = now
            # "reporting" means heard from recently: a silent client ages
            # out of the gauge
            n = sum(1 for ts in self.last_seen.values()
                    if now - ts <= self.heartbeat_window_s)
        self._reg.gauge("health/clients_reporting").set(n)
        if fields and fields.get("mem_bytes"):
            try:
                mem = float(fields["mem_bytes"])
            except (TypeError, ValueError):
                mem = float("nan")
            if math.isfinite(mem):
                self._reg.gauge("health/client_mem_bytes",
                                labels={"client": str(client_id)}).set(mem)
            else:
                self._nonfinite_dropped(client_id, "mem_bytes")

    def _nonfinite_dropped(self, client_id: Any, field: str) -> None:
        """A NaN/Inf reading is dropped (one NaN would poison every
        median/MAD downstream), counted and left for the doctor."""
        self._reg.counter("health/nonfinite_dropped").inc()
        logger.warning("dropping non-finite %s heartbeat field from client %s",
                       field, client_id)

    def observe(self, client_id: Any, round_idx: int,
                latency_s: Optional[float] = None,
                update_norm: Optional[float] = None,
                train_loss: Optional[float] = None,
                heartbeat: Optional[Dict] = None) -> None:
        with self._lock:
            obs = self._pending.setdefault(int(round_idx), {}).setdefault(client_id, {})
            if latency_s is not None:
                if math.isfinite(latency_s):
                    obs["latency_s"] = float(latency_s)
                else:
                    self._nonfinite_dropped(client_id, "latency")
            if update_norm is not None and math.isfinite(update_norm):
                obs["update_norm"] = float(update_norm)
            if train_loss is not None:
                try:
                    loss = float(train_loss)
                except (TypeError, ValueError):
                    loss = None
                if loss is not None:
                    if math.isfinite(loss):
                        obs["train_loss"] = loss
                    else:
                        self._nonfinite_dropped(client_id, "train_loss")
            self.last_seen[client_id] = time.time()
        if heartbeat:
            self.heartbeat(client_id, heartbeat)

    # -- scoring ----------------------------------------------------------------
    def finish_round(self, round_idx: int) -> Dict[Any, Dict]:
        """Score the round's cohort; returns {client: health record}."""
        with self._lock:
            cohort = self._pending.pop(int(round_idx), {})
            if not cohort:
                return {}
            a = self.ewma_alpha
            lats = {}
            for cid, obs in cohort.items():
                lat = obs.get("latency_s")
                if lat is None:
                    continue
                lats[cid] = lat
                prev = self.latency_ewma.get(cid)
                self.latency_ewma[cid] = lat if prev is None else a * lat + (1 - a) * prev
            med_lat = _median(list(lats.values())) if lats else 0.0
            z_norm = robust_z({c: o["update_norm"] for c, o in cohort.items()
                               if "update_norm" in o})
            z_loss = robust_z({c: o["train_loss"] for c, o in cohort.items()
                               if "train_loss" in o})
            out: Dict[Any, Dict] = {}
            for cid, obs in cohort.items():
                # per-round scores against THIS round's cohort; a client's
                # scores are medians across rounds, and a flag needs
                # min_rounds of evidence
                round_score = (lats[cid] / med_lat
                               if cid in lats and med_lat > 0 else 1.0)
                hist = self._score_hist.setdefault(cid, deque(maxlen=64))
                hist.append(round_score)
                s_score = _median(list(hist))
                raw_anom = max(abs(z_norm.get(cid, 0.0)), abs(z_loss.get(cid, 0.0)))
                zh = self._z_hist.setdefault(cid, deque(maxlen=64))
                zh.append(raw_anom)
                anom = _median(list(zh))
                enough = len(hist) >= self.min_rounds
                out[cid] = {
                    "kind": "client_health",
                    "round": int(round_idx),
                    "client": cid,
                    "latency_ms": round(obs["latency_s"] * 1e3, 3)
                    if "latency_s" in obs else None,
                    "latency_ewma_ms": (round(self.latency_ewma[cid] * 1e3, 3)
                                        if cid in self.latency_ewma else None),
                    "update_norm": obs.get("update_norm"),
                    "train_loss": obs.get("train_loss"),
                    "z_norm": round(z_norm.get(cid, 0.0), 3),
                    "z_loss": round(z_loss.get(cid, 0.0), 3),
                    "round_straggler_score": round(round_score, 3),
                    "straggler_score": round(s_score, 3),
                    "round_max_abs_z": round(raw_anom, 3),
                    "anomaly_score": round(anom, 3),
                    "flagged_straggler": enough and s_score >= self.straggler_threshold,
                    "flagged_anomaly": enough and anom >= self.anomaly_threshold,
                }
            self.rounds_scored += 1
        for cid, rec in out.items():
            labels = {"client": str(cid)}
            self._reg.gauge("health/straggler_score", labels=labels).set(
                rec["straggler_score"])
            self._reg.gauge("health/anomaly_score", labels=labels).set(
                rec["anomaly_score"])
            if rec["latency_ms"] is not None:
                self._reg.histogram("health/client_round_ms",
                                    labels=labels).observe(rec["latency_ms"])
            log_health_event(rec)
            if rec["flagged_straggler"] or rec["flagged_anomaly"]:
                flight_recorder.record("health_flag",
                                       **{k: v for k, v in rec.items() if k != "kind"})
        self._reg.counter("health/rounds_scored").inc()
        return out

    # -- outputs ----------------------------------------------------------------
    def flagged(self) -> Dict[str, List]:
        with self._lock:
            return {
                "stragglers": sorted(
                    c for c, h in self._score_hist.items()
                    if len(h) >= self.min_rounds
                    and _median(list(h)) >= self.straggler_threshold),
                "anomalies": sorted(
                    c for c, h in self._z_hist.items()
                    if len(h) >= self.min_rounds
                    and _median(list(h)) >= self.anomaly_threshold),
            }

    def snapshot(self) -> Dict[str, Dict]:
        with self._lock:
            return {
                "latency_ewma_s": dict(self.latency_ewma),
                "straggler_score": {c: _median(list(h))
                                    for c, h in self._score_hist.items() if h},
                "anomaly_score": {c: _median(list(h))
                                  for c, h in self._z_hist.items() if h},
                "rounds_scored": self.rounds_scored,
            }


__all__ = [
    "HEALTH_FILENAME",
    "ClientHealthTracker",
    "log_health_event",
    "update_norm",
]
