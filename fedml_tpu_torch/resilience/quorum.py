"""Round deadlines and quorum — counterpart of
``fedml_tpu/resilience/quorum.py``.

The server arms one :class:`RoundDeadline` a round after the broadcast. A
round completes when every expected upload arrived, or when the deadline
expired and at least ``quorum_size(expected, quorum)`` did; the FedAvg
weights renormalize over the uploads received.
"""
from __future__ import annotations

import logging
import math
import threading
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)


def quorum_size(expected: int, quorum_frac: float) -> int:
    """Minimum uploads to aggregate: ceil(frac * expected), at least 1."""
    return max(1, min(int(expected), int(math.ceil(float(quorum_frac) * int(expected)))))


def adaptive_deadline_s(latency_ewma_s: Dict, multiplier: float, grace_s: float,
                        min_s: float, static_ceiling_s: float) -> float:
    """The next round's deadline from per-client latency EWMAs: the static
    ceiling without history, else multiplier x median + grace, clamped to
    [min_s, ceiling]."""
    vals = sorted(float(v) for v in latency_ewma_s.values())
    if not vals or static_ceiling_s <= 0:
        return static_ceiling_s
    mid = len(vals) // 2
    med = vals[mid] if len(vals) % 2 else 0.5 * (vals[mid - 1] + vals[mid])
    return max(min_s, min(static_ceiling_s, multiplier * med + grace_s))


class RoundDeadline:
    """One re-armable timer; firing calls back with the armed round on the
    timer thread. The owner takes its own round lock and ignores fires for
    rounds already closed."""

    def __init__(self, on_expire: Callable[[int], None]):
        self._on_expire = on_expire
        self._timer: Optional[threading.Timer] = None
        self._armed_round: Optional[int] = None
        self._lock = threading.Lock()

    def arm(self, round_idx: int, timeout_s: float) -> None:
        if timeout_s <= 0:
            return
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
            self._armed_round = int(round_idx)
            t = threading.Timer(float(timeout_s), self._fire, (int(round_idx),))
            t.daemon = True
            t.start()
            self._timer = t
        logger.debug("round %d deadline armed: %.2fs", round_idx, timeout_s)

    def _fire(self, round_idx: int) -> None:
        with self._lock:
            if self._armed_round != round_idx:
                return  # re-armed for a newer round
            self._timer = None
        self._on_expire(round_idx)

    def cancel(self) -> None:
        with self._lock:
            if self._timer is not None:
                self._timer.cancel()
                self._timer = None
            self._armed_round = None
