"""TraceController — budgeted device traces, one owner per process. The
port's twin of ``fedml_tpu/telemetry/profiling/trace.py``, on
``torch.profiler`` where the reference drives ``jax.profiler``.

A profiler session is a process singleton: two owners fighting over it
lose both traces. This controller is the one place a trace may start
from, with three arms:

- **explicit**: ``telemetry profile <cmd>`` (or ``tree --trace-rounds``,
  the ``trace_rounds`` config knob) arms round indices via the
  ``FEDML_TRACE_ROUNDS`` / ``FEDML_TRACE_DIR`` env, read at first use;
- **manual**: ``MLOpsProfilerEvent.start_trace/stop_trace`` delegates
  here;
- **automatic**: :meth:`request_capture` arms one bounded capture for the
  next round boundary (its caller, the online doctor, is ROADMAP A12c's)
  — at most one per rule per run, at most ``max_captures`` in all, the
  trace bytes capped by ``byte_budget``.

A capture is ``torch.profiler.profile`` with CPU activity and, when the
card is there, CUDA activity (CUPTI: every kernel launched in the process,
the port's own included), without stacks or shapes, exported as a Chrome
trace (``trace.json``) into ``<run_dir>/traces/round<r>_<rule>/``. A
profiler that cannot start sets :attr:`TraceController.unavailable` and
the run goes on.

Every capture lands a ``profile_capture`` marker in the flight recorder
and in ``<run_dir>/telemetry.jsonl``, plus a ``profile/captures`` counter
labelled by trigger.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Set

from fedml_tpu_torch.telemetry import flight_recorder
from fedml_tpu_torch.telemetry.registry import get_registry

__all__ = ["AUTO_CAPTURE_RULES", "TraceController", "configure_from_args",
           "get_trace_controller", "parse_rounds", "reset_trace_controller"]

logger = logging.getLogger(__name__)

# rules whose online-doctor alerts request an automatic capture
AUTO_CAPTURE_RULES = ("straggler", "memory_growth", "stale_serving_round",
                      "slo_burn")

TRACE_FILENAME = "trace.json"


def parse_rounds(spec: Any) -> List[int]:
    """The one parser for every round-list surface (``--trace-rounds``,
    the ``trace_rounds`` knob, the ``FEDML_TRACE_ROUNDS`` env):
    comma-separated non-negative round indices; anything else in the list
    is rejected loudly rather than silently dropped."""
    if spec is None:
        return []
    out: List[int] = []
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if not tok.isdigit():
            raise ValueError(
                f"trace rounds must be comma-separated non-negative "
                f"integers; got {tok!r} in {spec!r}")
        out.append(int(tok))
    return out


class TraceController:
    def __init__(self, max_captures: int = 3,
                 byte_budget: int = 512 * 1024 * 1024,
                 trace_dir: Optional[str] = None):
        self.max_captures = int(
            os.environ.get("FEDML_TRACE_MAX_CAPTURES", max_captures))
        self.byte_budget = int(
            os.environ.get("FEDML_TRACE_BYTE_BUDGET", byte_budget))
        self._trace_dir = trace_dir or os.environ.get("FEDML_TRACE_DIR")
        self._armed_rounds: Set[int] = set(
            parse_rounds(os.environ.get("FEDML_TRACE_ROUNDS", "")))
        self._lock = threading.Lock()
        self._active: Optional[Dict[str, Any]] = None
        self._pending: List[Dict[str, Any]] = []
        self._rules_captured: Set[str] = set()
        self._prof = None
        self.captures: List[Dict[str, Any]] = []
        self.bytes_captured = 0
        self.unavailable: Optional[str] = None

    # -- arming ------------------------------------------------------------
    def arm_rounds(self, rounds, trace_dir: Optional[str] = None) -> None:
        with self._lock:
            self._armed_rounds.update(int(r) for r in rounds)
            if trace_dir:
                self._trace_dir = trace_dir

    def request_capture(self, rule: str, reason: str = "",
                        node: Optional[str] = None,
                        round_idx: Optional[int] = None) -> bool:
        """Arm one bounded capture for the next round boundary. Deduped:
        at most one auto capture per rule per run; refused past the
        count/byte budget. Returns whether the request was accepted."""
        with self._lock:
            if rule in self._rules_captured:
                return False
            if len(self.captures) + len(self._pending) >= self.max_captures:
                return False
            if self.bytes_captured >= self.byte_budget:
                return False
            self._rules_captured.add(rule)
            self._pending.append({"rule": rule, "reason": reason,
                                  "node": node, "alert_round": round_idx})
        return True

    # -- round hooks (sp / tree / cross-silo loops) ------------------------
    def on_round_start(self, round_idx: int,
                       run_dir: Optional[str] = None) -> bool:
        """Start a capture for this round if one is armed (explicit round
        list or a pending auto request). Returns whether a trace is now
        recording."""
        round_idx = int(round_idx)
        with self._lock:
            if self._active is not None or self.unavailable:
                return self._active is not None
            trigger = None
            if round_idx in self._armed_rounds:
                trigger = {"rule": "explicit", "reason": "armed round",
                           "node": None, "alert_round": None}
            elif self._pending:
                trigger = self._pending.pop(0)
            if trigger is None:
                return False
            trace_dir = self._capture_dir(round_idx, trigger["rule"],
                                          run_dir)
            self._active = {**trigger, "round": round_idx,
                            "trace_dir": trace_dir,
                            "started": time.time()}
        return self._start(trace_dir)

    def on_round_end(self, round_idx: int,
                     run_dir: Optional[str] = None) -> Optional[Dict]:
        """Stop the capture this round owns (no-op otherwise) and land
        the ``profile_capture`` marker."""
        with self._lock:
            active = self._active
            if active is None or active["round"] != int(round_idx):
                return None
            self._active = None
        ok = self._stop(active["trace_dir"])
        nbytes = _dir_bytes(active["trace_dir"]) if ok else 0
        marker = {
            "kind": "profile_capture",
            "ts": time.time(),
            "round": active["round"],
            "rule": active["rule"],
            "reason": active.get("reason"),
            "node": active.get("node"),
            "alert_round": active.get("alert_round"),
            "trace_dir": active["trace_dir"],
            "trace_bytes": nbytes,
            "ok": ok,
        }
        with self._lock:
            # budget state mutates under the lock request_capture reads it
            # with, so a concurrent request can't slip past the budget
            self.bytes_captured += nbytes
            self.captures.append(marker)
        get_registry().counter(
            "profile/captures", labels={"trigger": active["rule"]}).inc()
        flight_recorder.record(**marker)
        self._append_marker(marker, run_dir)
        if self.bytes_captured >= self.byte_budget:
            logger.warning(
                "trace byte budget exhausted (%d >= %d): no further "
                "captures this run", self.bytes_captured, self.byte_budget)
        return marker

    def finish(self) -> None:
        """Stop any capture left open (run teardown safety)."""
        with self._lock:
            active, self._active = self._active, None
        if active is not None:
            self._stop(active["trace_dir"])

    # -- manual arm (mlops facade) -----------------------------------------
    def start_manual(self, trace_dir: str) -> bool:
        with self._lock:
            if self._active is not None or self.unavailable:
                return False
            self._active = {"rule": "manual", "reason": "mlops facade",
                            "node": None, "alert_round": None,
                            "round": -1, "trace_dir": trace_dir,
                            "started": time.time()}
        return self._start(trace_dir)

    def stop_manual(self) -> Optional[Dict]:
        with self._lock:
            if self._active is None or self._active["rule"] != "manual":
                return None
        return self.on_round_end(-1)

    # -- internals ---------------------------------------------------------
    def _capture_dir(self, round_idx: int, rule: str,
                     run_dir: Optional[str]) -> str:
        base = self._trace_dir
        if base is None:
            if run_dir is None:
                from fedml_tpu_torch.telemetry.spans import get_tracer

                run_dir = get_tracer().sink_dir or ".fedml_logs/traces"
            base = os.path.join(run_dir, "traces")
        return os.path.join(base, f"round{round_idx}_{rule}")

    def _start(self, trace_dir: str) -> bool:
        try:
            import torch
            from torch.profiler import ProfilerActivity, profile

            os.makedirs(trace_dir, exist_ok=True)
            activities = [ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.start()
            self._prof = prof
            return True
        except Exception as e:  # noqa: BLE001 - a broken profiler must not kill runs
            logger.warning("device trace unavailable: %s", e)
            with self._lock:
                self.unavailable = f"{type(e).__name__}: {e}"[:200]
                self._active = None
            return False

    def _stop(self, trace_dir: str) -> bool:
        prof, self._prof = self._prof, None
        if prof is None:
            return False
        try:
            prof.stop()
            prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILENAME))
            return True
        except Exception as e:  # noqa: BLE001 - stop after a failed start
            logger.warning("stopping the device trace failed: %s", e)
            return False

    def _append_marker(self, marker: Dict, run_dir: Optional[str]) -> None:
        if run_dir is None:
            from fedml_tpu_torch.telemetry.spans import get_tracer

            run_dir = get_tracer().sink_dir
        if run_dir is None:
            return
        try:
            os.makedirs(run_dir, exist_ok=True)
            with open(os.path.join(run_dir, "telemetry.jsonl"), "a") as f:
                f.write(json.dumps(marker, default=str) + "\n")
        except OSError:  # the sink dir is gone
            pass


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _, files in os.walk(path):
        for fn in files:
            try:
                total += os.path.getsize(os.path.join(root, fn))
            except OSError:  # raced deletion
                pass
    return total


def configure_from_args(args: Any) -> None:
    """Apply the run config's trace knobs: ``trace_max_captures`` /
    ``trace_byte_budget`` budget the captures, ``trace_rounds`` +
    ``trace_dir`` arm explicit rounds — the config twin of the
    ``FEDML_TRACE_*`` env and the ``--trace-rounds`` flags."""
    tc = get_trace_controller()
    mc = getattr(args, "trace_max_captures", None)
    if mc is not None:
        tc.max_captures = int(mc)
    bb = getattr(args, "trace_byte_budget", None)
    if bb is not None:
        tc.byte_budget = int(bb)
    rounds = getattr(args, "trace_rounds", None)
    if rounds:
        tc.arm_rounds(parse_rounds(rounds),
                      trace_dir=getattr(args, "trace_dir", None))


_controller: Optional[TraceController] = None
_controller_lock = threading.Lock()


def get_trace_controller() -> TraceController:
    global _controller
    with _controller_lock:
        if _controller is None:
            _controller = TraceController()
        return _controller


def reset_trace_controller() -> None:
    """Drop the process-global controller (test isolation); stops any
    trace left recording."""
    global _controller
    with _controller_lock:
        old, _controller = _controller, None
    if old is not None:
        old.finish()
