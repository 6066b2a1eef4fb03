"""Flight recorder — a bounded black box for post-mortem run triage.

The port's twin of ``fedml_tpu/telemetry/flight_recorder.py``. It keeps
the last few thousand telemetry events (spans, comm sends and receives,
round markers) in a byte-budgeted in-memory ring and lands them as
``<run_dir>/flight_recorder.jsonl`` when the process ends:

- **SIGTERM** and **SIGINT**: a ``signal`` record naming the signal goes
  into the ring, the ring is dumped, and the previous handler runs; where
  there was none, the default disposition is restored and the signal
  re-raised, so the exit status stays the signal's (SIGINT's default
  handler raises KeyboardInterrupt as usual). The handlers are installed
  only from the main thread, over whatever handler was there before;
- **an unhandled exception** (``sys.excepthook`` in the main thread,
  ``threading.excepthook`` in any other): dump with the exception's type,
  message and traceback, then the previous hook;
- **exit**: dump unless a crash path already did, and never into a run
  dir that existed and has been removed meanwhile (a test's temporary
  directory): the exit writers neither raise nor recreate it.

Events are serialized at ``record()`` time (one ``json.dumps``, kept as
the final line), so the byte budget is exact and the dump, which may run
inside a signal handler, only writes finished lines. ``Tracer.end`` feeds
every completed span in through :func:`on_span`; the ring evicts oldest
first, so a flood of spans never grows it past ``max_bytes``.
"""
from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = [
    "FlightRecorder",
    "get_flight_recorder",
    "record",
    "on_span",
    "bind",
    "reset_flight_recorder",
    "note_dir",
    "removed_since_seen",
]

DUMP_FILENAME = "flight_recorder.jsonl"

# reasons that mark a crash dump; a later exit dump must not overwrite the
# crash context they captured
_CRASH_REASONS = ("sigterm", "sigint", "exception", "handler_error")

# run dirs a telemetry writer of this process has seen on disk
_seen_dirs: set = set()


def note_dir(path: str) -> None:
    """Remember that ``path`` existed (a writer made it or wrote into it)."""
    _seen_dirs.add(os.path.abspath(path))


def removed_since_seen(path: str) -> bool:
    """True when ``path`` existed for a writer of this process and is gone:
    exit-time writers then leave it gone."""
    return os.path.abspath(path) in _seen_dirs and not os.path.isdir(path)


class FlightRecorder:
    """Byte-budgeted ring of serialized telemetry events.

    An ``RLock``: the SIGTERM handler runs on the main thread and may
    interrupt a ``record()`` in progress there, which a plain lock would
    deadlock on.
    """

    def __init__(self, max_bytes: int = 1 << 20, max_events: int = 4096):
        self.max_bytes = int(max_bytes)
        self.max_events = int(max_events)
        self._lines: "deque[str]" = deque()
        self._sizes: "deque[int]" = deque()
        self._bytes = 0
        self._lock = threading.RLock()
        self._dir: Optional[str] = None
        self.dumped_reason: Optional[str] = None
        self.dropped = 0

    # -- recording --------------------------------------------------------
    def record(self, kind: str, **fields: Any) -> None:
        rec = {"ts": time.time(), "kind": str(kind), **fields}
        line = json.dumps(rec, default=str)
        size = len(line) + 1
        with self._lock:
            self._lines.append(line)
            self._sizes.append(size)
            self._bytes += size
            while self._lines and (self._bytes > self.max_bytes
                                   or len(self._lines) > self.max_events):
                self._lines.popleft()
                self._bytes -= self._sizes.popleft()
                self.dropped += 1

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self._bytes

    def __len__(self) -> int:
        with self._lock:
            return len(self._lines)

    def snapshot(self) -> List[Dict]:
        with self._lock:
            lines = list(self._lines)
        return [json.loads(line) for line in lines]

    def last_round(self) -> Optional[int]:
        """The round of the newest event that carries one."""
        with self._lock:
            lines = list(self._lines)
        for line in reversed(lines):
            rec = json.loads(line)
            if "round" in rec:
                try:
                    return int(rec["round"])
                except (TypeError, ValueError):
                    continue
        return None

    # -- binding and dumping ----------------------------------------------
    def bind(self, run_dir: str) -> None:
        self._dir = run_dir
        if os.path.isdir(run_dir):
            note_dir(run_dir)

    @property
    def sink_dir(self) -> Optional[str]:
        return self._dir

    def dump(self, run_dir: Optional[str] = None, reason: str = "manual",
             exc: Optional[BaseException] = None) -> Optional[str]:
        """Write the ring (oldest to newest) behind one ``crash_context``
        header; each dump replaces the previous one."""
        target = run_dir or self._dir
        if target is None:
            return None
        if reason == "atexit" and removed_since_seen(target):
            return None  # the run dir went away before the interpreter did
        header: Dict[str, Any] = {
            "ts": time.time(),
            "kind": "crash_context",
            "reason": reason,
            "n_events": len(self),
            "dropped": self.dropped,
            "pid": os.getpid(),
        }
        lr = self.last_round()
        if lr is not None:
            header["last_round"] = lr
        if exc is not None:
            header["exc_type"] = type(exc).__name__
            header["exc_message"] = str(exc)
            header["traceback"] = "".join(traceback.format_exception(
                type(exc), exc, exc.__traceback__))[-4096:]
        with self._lock:
            lines = list(self._lines)
        text = "".join(line + "\n" for line in [json.dumps(header, default=str), *lines])
        try:
            os.makedirs(target, exist_ok=True)
            note_dir(target)
            path = os.path.join(target, DUMP_FILENAME)
            with open(path, "w") as f:
                f.write(text)
        except OSError:
            return None
        self.dumped_reason = reason
        return path


_recorder = FlightRecorder()
_recorder_lock = threading.Lock()
_hooks_lock = threading.Lock()
_hooks_installed = False
_signals_installed = False


def get_flight_recorder() -> FlightRecorder:
    return _recorder


def record(kind: str, **fields: Any) -> None:
    """One event into the process-global ring (the ring exists before a run
    dir is bound)."""
    _recorder.record(kind, **fields)


def on_span(rec: Dict) -> None:
    """The span feed from ``Tracer.end``: a condensed copy rides the ring."""
    _recorder.record("span", name=rec.get("name"),
                     duration_ms=round(float(rec.get("duration_ms", 0.0)), 3),
                     started=rec.get("started"))


def reset_flight_recorder() -> None:
    """A fresh unbound ring (test isolation). The hooks stay installed:
    they act on whichever recorder is current."""
    global _recorder
    with _recorder_lock:
        _recorder = FlightRecorder()


# -- crash hooks -----------------------------------------------------------
def _dump_current(reason: str, exc: Optional[BaseException] = None) -> None:
    rec = _recorder
    if rec.sink_dir is not None:
        rec.dump(reason=reason, exc=exc)


def _chain_signal(sig: int, reason: str) -> None:
    """Dump, then hand the signal to the handler that was there before."""
    prev = signal.getsignal(sig)

    def _on_signal(signum, frame):
        _recorder.record("signal", signal=signal.Signals(signum).name, signum=int(signum))
        _dump_current(reason)
        if callable(prev) and prev not in (signal.SIG_DFL, signal.SIG_IGN):
            prev(signum, frame)
            return
        if prev == signal.SIG_IGN:
            return
        # a real signal death, not a masked clean exit
        signal.signal(signum, signal.SIG_DFL)
        os.kill(os.getpid(), signum)

    signal.signal(sig, _on_signal)


def _install_hooks() -> None:
    global _hooks_installed, _signals_installed
    with _hooks_lock:
        if not _hooks_installed:
            _hooks_installed = True
            prev_excepthook = sys.excepthook

            def _excepthook(exc_type, exc, tb):
                _dump_current("exception", exc)
                prev_excepthook(exc_type, exc, tb)

            sys.excepthook = _excepthook
            prev_thread_hook = threading.excepthook

            def _thread_hook(args):
                _dump_current("exception", args.exc_value)
                prev_thread_hook(args)

            threading.excepthook = _thread_hook

            def _atexit_dump():
                if _recorder.dumped_reason not in _CRASH_REASONS:
                    _dump_current("atexit")

            atexit.register(_atexit_dump)
        # signal.signal works only in the main thread: a run configured from
        # another thread keeps the exception and exit dumps, and the first
        # bind from the main thread adds the signal handlers
        if not _signals_installed and threading.current_thread() is threading.main_thread():
            _signals_installed = True
            _chain_signal(signal.SIGTERM, "sigterm")
            _chain_signal(signal.SIGINT, "sigint")


def bind(run_dir: str) -> FlightRecorder:
    """Point the global recorder at a run dir and arm the crash hooks
    (``telemetry.configure`` calls it, so every engine that lands spans in
    a run dir gets the recorder)."""
    _recorder.bind(run_dir)
    _install_hooks()
    return _recorder
