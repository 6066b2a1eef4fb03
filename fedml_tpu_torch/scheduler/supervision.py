"""Run supervision policy — the port's copy of three names of
``fedml_tpu/scheduler/supervision.py`` (:43-147): restart backoff and
crash-loop containment, for the kill-and-respawn runner
(``resilience/durability/recover``). The rest of the scheduler comes with
ROADMAP A13.

Policy:

* **restart** — any abnormal exit (a nonzero rc, a signal death) relaunches
  after an exponential backoff ``backoff_s * 2^k`` capped at
  ``max_backoff_s``; the schedule is un-jittered, so two supervisors with
  one policy give the same delays.
* **crash-loop containment** — ``crash_loop_threshold`` consecutive failures
  that are both fast (the process lived less than ``fast_fail_s``) and
  identical (the same rc) stop the relaunching. A slow failure or another
  rc resets the streak.
* **give-up** — ``max_restarts`` relaunches bound the budget.
* **resume** — durable jobs relaunch to re-enter through the write-ahead
  journal rather than from round 0.
"""
from __future__ import annotations

import json
import signal
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["RestartPolicy", "RestartTracker", "describe_rc"]


def describe_rc(rc: Optional[int]) -> str:
    """A readable exit code (``rc=-15 (SIGTERM)`` / ``rc=7``)."""
    if rc is None:
        return "rc=unknown"
    if rc < 0:
        try:
            name = signal.Signals(-rc).name
        except ValueError:
            name = f"signal {-rc}"
        return f"rc={rc} ({name})"
    return f"rc={rc}"


class RestartPolicy:
    """The per-run supervision knobs (a job's ``restart:`` block)."""

    def __init__(self, max_restarts: int = 0, backoff_s: float = 0.5,
                 max_backoff_s: float = 30.0, crash_loop_threshold: int = 3,
                 fast_fail_s: float = 5.0, resume: bool = True):
        self.max_restarts = max(0, int(max_restarts))
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.crash_loop_threshold = max(1, int(crash_loop_threshold))
        self.fast_fail_s = float(fast_fail_s)
        self.resume = bool(resume)

    @classmethod
    def from_spec(cls, raw: Any) -> Optional["RestartPolicy"]:
        """None (no supervision) unless the spec asks for it: a dict, a
        JSON string, or a bare int (= max_restarts)."""
        if raw in (None, "", False, 0):
            return None
        if isinstance(raw, str):
            raw = json.loads(raw)
        if isinstance(raw, bool):
            raw = {"max_restarts": 3}
        if isinstance(raw, int):
            raw = {"max_restarts": raw}
        if not isinstance(raw, dict):
            raise ValueError(
                f"restart policy must be a dict/int/bool, got {type(raw).__name__}")
        allowed = {"max_restarts", "backoff_s", "max_backoff_s",
                   "crash_loop_threshold", "fast_fail_s", "resume"}
        bad = set(raw) - allowed
        if bad:
            raise ValueError(f"unknown restart policy keys: {sorted(bad)}")
        pol = cls(**raw)
        return pol if pol.max_restarts > 0 else None

    def to_dict(self) -> Dict:
        return {"max_restarts": self.max_restarts, "backoff_s": self.backoff_s,
                "max_backoff_s": self.max_backoff_s,
                "crash_loop_threshold": self.crash_loop_threshold,
                "fast_fail_s": self.fast_fail_s, "resume": self.resume}


class RestartTracker:
    """One run's supervision state; ask :meth:`on_exit` after each death.
    Not thread-safe: its callers serialise."""

    def __init__(self, policy: RestartPolicy):
        self.policy = policy
        self.restarts = 0            # relaunches performed
        self.fast_streak = 0         # consecutive fast identical failures
        self.last_rc: Optional[int] = None
        self.delays_s: List[float] = []  # the backoff schedule used

    def on_exit(self, rc: Optional[int], uptime_s: float) -> Tuple[str, Any]:
        """Judge one abnormal exit: ``("restart", delay_s)``,
        ``("crash_loop", reason)`` or ``("give_up", reason)``."""
        fast = uptime_s < self.policy.fast_fail_s
        if fast and rc == self.last_rc:
            self.fast_streak += 1
        else:
            self.fast_streak = 1 if fast else 0
        self.last_rc = rc
        if self.fast_streak >= self.policy.crash_loop_threshold:
            return ("crash_loop",
                    f"crash-loop contained: {self.fast_streak} consecutive fast "
                    f"(<{self.policy.fast_fail_s:g}s) identical failures "
                    f"({describe_rc(rc)}) after backoff "
                    f"{[round(d, 3) for d in self.delays_s]}")
        if self.restarts >= self.policy.max_restarts:
            return ("give_up",
                    f"restart budget exhausted: {self.restarts} relaunch(es) already "
                    f"spent, last exit {describe_rc(rc)}")
        delay = min(self.policy.backoff_s * (2.0 ** self.restarts), self.policy.max_backoff_s)
        self.restarts += 1
        self.delays_s.append(delay)
        return ("restart", delay)
