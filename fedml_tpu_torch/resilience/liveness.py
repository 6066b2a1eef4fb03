"""Peer liveness — counterpart of ``fedml_tpu/resilience/liveness.py``:
last-seen times per peer and an evicted set, fed by every message a peer
sends; eviction is the caller's policy. (The reference's silent-window
sweep has no caller on the synchronous path and is not ported.)"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional


class PeerLiveness:
    def __init__(self, silent_after_s: float = 30.0):
        self.silent_after_s = float(silent_after_s)
        self._lock = threading.Lock()
        self._last_seen: Dict[Any, float] = {}
        self._evicted: Dict[Any, float] = {}

    def note(self, peer: Any, now: Optional[float] = None) -> None:
        with self._lock:
            self._last_seen[peer] = time.time() if now is None else now

    def evict(self, peer: Any) -> bool:
        """Mark evicted; False if it already was."""
        with self._lock:
            if peer in self._evicted:
                return False
            self._evicted[peer] = time.time()
            return True

    def is_evicted(self, peer: Any) -> bool:
        with self._lock:
            return peer in self._evicted

    def readmit(self, peer: Any) -> bool:
        """Clear the evicted mark on reconnect; False if it was not set."""
        with self._lock:
            self._last_seen[peer] = time.time()
            return self._evicted.pop(peer, None) is not None

    def evicted(self) -> List[Any]:
        with self._lock:
            return sorted(self._evicted)
