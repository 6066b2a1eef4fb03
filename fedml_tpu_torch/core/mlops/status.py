"""Run-status state machine.

Counterpart of ``fedml_tpu/core/mlops/status.py`` (the reference's
``mlops_status.py`` and its agents' status constants): one machine
validates every transition and mirrors it to an observer (the local
metrics sink), so agents and engines share one source of truth.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional


class RunStatus:
    IDLE = "IDLE"
    QUEUED = "QUEUED"
    PROVISIONING = "PROVISIONING"
    RUNNING = "RUNNING"
    STOPPING = "STOPPING"
    # supervision: the run's process died abnormally and the agent is
    # waiting out the restart backoff before relaunching it
    RESTARTING = "RESTARTING"
    FINISHED = "FINISHED"
    FAILED = "FAILED"
    KILLED = "KILLED"
    # preemption: the run was gracefully quiesced (SIGTERM + grace) so a
    # master can reschedule it elsewhere; terminal FOR THIS AGENT — the
    # job plane supersedes the run with a resumed one on another node
    PREEMPTED = "PREEMPTED"
    EXCEPTION = "EXCEPTION"

    TERMINAL = {FINISHED, FAILED, KILLED, PREEMPTED, EXCEPTION}

    _ALLOWED = {
        IDLE: {QUEUED, PROVISIONING, RUNNING, KILLED},
        QUEUED: {PROVISIONING, RUNNING, KILLED, FAILED},
        PROVISIONING: {RUNNING, FAILED, KILLED, EXCEPTION},
        RUNNING: {STOPPING, RESTARTING, FINISHED, FAILED, KILLED, EXCEPTION},
        RESTARTING: {RUNNING, STOPPING, FAILED, KILLED},
        STOPPING: {KILLED, PREEMPTED, FINISHED, FAILED, EXCEPTION},
        FINISHED: set(),
        FAILED: set(),
        KILLED: set(),
        PREEMPTED: set(),
        EXCEPTION: set(),
    }

    @classmethod
    def can_transition(cls, src: str, dst: str) -> bool:
        return dst in cls._ALLOWED.get(src, set())


class RunStatusMachine:
    """Validated status holder for one run; mirrors changes to observers."""

    def __init__(self, run_id: Any, sink: Optional[Callable[[Dict], None]] = None):
        self.run_id = run_id
        self.status = RunStatus.IDLE
        self.history: List[Dict] = []
        self._sink = sink

    def transition(self, dst: str, reason: str = "") -> bool:
        """Returns True if applied; False (no-op) for an illegal move."""
        if dst == self.status:
            return True
        if not RunStatus.can_transition(self.status, dst):
            return False
        entry = {
            "run_id": self.run_id,
            "from": self.status,
            "to": dst,
            "reason": reason,
            "ts": time.time(),
        }
        self.status = dst
        self.history.append(entry)
        if self._sink is not None:
            try:
                self._sink(entry)
            except Exception:
                pass
        return True

    @property
    def is_terminal(self) -> bool:
        return self.status in RunStatus.TERMINAL
