"""Retry policy and resilience configuration — counterpart of
``fedml_tpu/resilience/policy.py``.

The backoff is deterministically jittered: the jitter of attempt ``k`` is a
hash of ``(seed, key, k)``, so a run with a fixed seed replays the same
retry timeline as the reference's.
"""
from __future__ import annotations

import hashlib
import logging
import struct
import time
from typing import Any, Callable, Iterator, Optional, Tuple

logger = logging.getLogger(__name__)


def _unit_hash(*parts: Any) -> float:
    """Deterministic uniform [0, 1) from arbitrary parts (stable across
    processes: Python's ``hash()`` is salted, hashlib is not)."""
    h = hashlib.blake2b("|".join(str(p) for p in parts).encode(),
                        digest_size=8).digest()
    (v,) = struct.unpack(">Q", h)
    return v / float(1 << 64)


def transient_exceptions() -> Tuple[type, ...]:
    """Exception types worth a resend: socket-level failures (the port has
    no gRPC transport, so nothing else)."""
    return (ConnectionError, TimeoutError, OSError)


class RetryPolicy:
    """Jittered exponential backoff, ``base * 2^k ± jitter``, capped; two
    policies with the same (seed, key) give the same delays."""

    def __init__(self, max_attempts: int = 4, base_delay_s: float = 0.05,
                 max_delay_s: float = 2.0, jitter: float = 0.5,
                 seed: int = 0, key: str = ""):
        self.max_attempts = max(1, int(max_attempts))
        self.base_delay_s = float(base_delay_s)
        self.max_delay_s = float(max_delay_s)
        self.jitter = float(jitter)
        self.seed = int(seed)
        self.key = str(key)

    def delays(self) -> Iterator[float]:
        """The delay after each failed attempt (one fewer than
        ``max_attempts``: the last failure is terminal)."""
        for k in range(self.max_attempts - 1):
            raw = min(self.base_delay_s * (2.0 ** k), self.max_delay_s)
            factor = 1.0 + self.jitter * (2.0 * _unit_hash(self.seed, self.key, k) - 1.0)
            yield max(0.0, raw * factor)

    def call(self, fn: Callable[[], Any],
             retry_on: Optional[Tuple[type, ...]] = None,
             on_retry: Optional[Callable[[int, BaseException], None]] = None,
             sleep: Callable[[float], None] = time.sleep) -> Any:
        """Run ``fn`` with backoff; re-raises the last failure."""
        retry_on = retry_on or transient_exceptions()
        delays = self.delays()
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                attempt += 1
                try:
                    delay = next(delays)
                except StopIteration:
                    raise e
                if on_retry is not None:
                    on_retry(attempt, e)
                logger.warning("transient send failure (attempt %d/%d): %r",
                               attempt, self.max_attempts, e)
                sleep(delay)


class ResilienceConfig:
    """The resilience knobs, read once off the args, with the reference's
    defaults: dedup and a bounded send retry always; a round deadline and
    quorum only with ``round_deadline_s`` or ``round_quorum``; client
    heartbeats only with ``heartbeat_interval_s`` > 0."""

    def __init__(self, args: Any = None):
        def g(k, d):
            return getattr(args, k, d) if args is not None else d

        self.send_max_retries = int(g("send_max_retries", 4))
        self.retry_base_s = float(g("retry_base_s", 0.05))
        self.retry_max_s = float(g("retry_max_s", 2.0))
        self.seed = int(g("random_seed", 0))
        deadline = g("round_deadline_s", None)
        self.round_deadline_s = float(deadline) if deadline else 0.0
        quorum = g("round_quorum", None)
        self.round_quorum = float(quorum) if quorum is not None else (
            2.0 / 3.0 if self.round_deadline_s else 1.0)
        if not (0.0 < self.round_quorum <= 1.0):
            raise ValueError(f"round_quorum must be in (0, 1], got {self.round_quorum}")
        self.deadline_adaptive = bool(g("round_deadline_adaptive", True))
        self.deadline_multiplier = float(g("round_deadline_multiplier", 4.0))
        self.deadline_grace_s = float(g("round_deadline_grace_s", 0.5))
        self.deadline_min_s = float(g("round_deadline_min_s", 1.0))
        # re-arms below quorum before the server aborts the federation
        self.deadline_extensions = int(g("round_deadline_extensions", 3))
        self.heartbeat_interval_s = float(g("heartbeat_interval_s", 0.0))

    @property
    def deadline_enabled(self) -> bool:
        return self.round_deadline_s > 0.0

    def retry_policy(self, key: str = "") -> RetryPolicy:
        return RetryPolicy(max_attempts=self.send_max_retries,
                           base_delay_s=self.retry_base_s,
                           max_delay_s=self.retry_max_s, seed=self.seed, key=key)
