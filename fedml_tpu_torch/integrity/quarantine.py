"""QuarantineList — time-boxed exclusion from selection; counterpart of
``fedml_tpu/integrity/quarantine.py``.

Eviction answers "is this peer alive?"; quarantine answers "is it
trusted?". A screened-out client is usually evicted too, probed and
readmitted on its next sign of life — but selection also asks this list,
so it sits out until its ``quarantine_rounds`` elapse. The counters and
gauge are the reference's: ``integrity/quarantined``,
``integrity/quarantine_released`` and ``integrity/quarantine_active``.
Each quarantine is also an ``integrity_event`` record in ``health.jsonl``
and the flight recorder (:func:`record_integrity_event`, which the screen
and the rollback guard use for theirs).
"""
from __future__ import annotations

import logging
import threading
from typing import Any, Dict, List, Optional

from fedml_tpu_torch.telemetry import flight_recorder, get_registry
from fedml_tpu_torch.telemetry.health import log_health_event

logger = logging.getLogger(__name__)

__all__ = ["QuarantineList", "record_integrity_event"]


def record_integrity_event(event: str, **fields) -> None:
    """One ``integrity_event`` record in ``health.jsonl`` and its copy in the
    flight recorder, where the doctor's integrity section reads them."""
    try:
        log_health_event({"kind": "integrity_event", "event": event, **fields})
    except OSError:  # observability never breaks the round
        logger.exception("integrity event logging failed")
    flight_recorder.record("integrity_event", event=event, **fields)


class QuarantineList:
    """client → the last round of its quarantine. A client quarantined at
    round ``r`` for ``rounds`` sits out rounds ``r+1 .. r+rounds``.
    Re-quarantining extends, never shortens. Thread-safe."""

    def __init__(self, rounds: int = 2, registry=None):
        self.rounds = int(rounds)
        self._reg = registry or get_registry()
        self._lock = threading.Lock()
        self._until: Dict[Any, int] = {}
        self._reason: Dict[Any, str] = {}

    def quarantine(self, client: Any, round_idx: int, reason: str = "") -> bool:
        """Quarantine ``client`` as of ``round_idx``; False if an equal or
        longer quarantine was already in place."""
        until = int(round_idx) + self.rounds
        with self._lock:
            if self._until.get(client, -1) >= until:
                return False
            self._until[client] = until
            self._reason[client] = str(reason)
            active = len(self._until)
        self._reg.counter("integrity/quarantined").inc()
        self._reg.gauge("integrity/quarantine_active").set(active)
        record_integrity_event("quarantined", client=client, round=int(round_idx),
                               until_round=until, reason=str(reason))
        logger.warning("client %s QUARANTINED until round %d: %s", client, until, reason)
        return True

    def is_quarantined(self, client: Any, round_idx: int) -> bool:
        with self._lock:
            until = self._until.get(client)
        return until is not None and int(round_idx) <= until

    def active(self, round_idx: int) -> List[Any]:
        """Clients quarantined at ``round_idx``; expired entries drop out."""
        released = []
        with self._lock:
            for c in [c for c, u in self._until.items() if u < int(round_idx)]:
                self._until.pop(c, None)
                self._reason.pop(c, None)
                released.append(c)
            out = sorted(self._until, key=str)
            active = len(self._until)
        if released:
            self._reg.counter("integrity/quarantine_released").inc(len(released))
            self._reg.gauge("integrity/quarantine_active").set(active)
            logger.info("quarantine released for %s at round %d", released, round_idx)
        return out

    def reason(self, client: Any) -> Optional[str]:
        with self._lock:
            return self._reason.get(client)

    def filter_selection(self, candidates: List[Any], round_idx: int) -> List[Any]:
        """Selection hook: the candidates minus the active quarantine."""
        q = set(self.active(round_idx))
        return [c for c in candidates if c not in q] if q else list(candidates)
