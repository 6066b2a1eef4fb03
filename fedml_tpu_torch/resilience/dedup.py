"""Receiver-side message dedup — counterpart of
``fedml_tpu/resilience/dedup.py``: a bounded LRU set of message ids, so a
resent message is applied once."""
from __future__ import annotations

import threading
from collections import OrderedDict


class MessageDeduper:
    """Bounded LRU membership set keyed by message id (thread-safe)."""

    def __init__(self, capacity: int = 4096):
        self.capacity = max(1, int(capacity))
        self._seen: "OrderedDict[str, None]" = OrderedDict()
        self._lock = threading.Lock()
        self.duplicates = 0

    def seen(self, msg_id: str) -> bool:
        """Record ``msg_id``; True if it was already recorded (drop it)."""
        key = str(msg_id)
        with self._lock:
            if key in self._seen:
                self._seen.move_to_end(key)
                self.duplicates += 1
                return True
            self._seen[key] = None
            while len(self._seen) > self.capacity:
                self._seen.popitem(last=False)
            return False

    def __len__(self) -> int:
        with self._lock:
            return len(self._seen)
