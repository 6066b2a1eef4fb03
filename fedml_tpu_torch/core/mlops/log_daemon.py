"""Runtime log daemon — tails a run's log file into the metrics sink.

Counterpart of ``fedml_tpu/core/mlops/log_daemon.py`` (the reference's
``mlops_runtime_log_daemon.py``): a daemon thread follows the file,
batches the complete lines appended to it and writes them into the JSONL
metrics sink tagged with the run id; a file that shrank (rotated or
truncated) is read again from its top.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Optional

from fedml_tpu_torch.core.mlops.metrics import MLOpsMetrics


class MLOpsRuntimeLogDaemon:
    def __init__(self, run_id: str, log_path: str, args: Any = None,
                 sink_dir: Optional[str] = None,
                 poll_interval: float = 0.2, batch_lines: int = 64):
        self.run_id = str(run_id)
        self.log_path = os.path.abspath(log_path)
        self._metrics = MLOpsMetrics(args, sink_dir=sink_dir)
        self._poll = float(poll_interval)
        self._batch = int(batch_lines)
        self._offset = 0
        self._line_no = 0
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        # flush() is public API and also the poll-thread body: without a
        # lock a caller's flush racing the daemon's reads the same byte
        # range twice and double-ships those log lines
        self._lock = threading.Lock()

    def start(self, from_beginning: bool = True) -> "MLOpsRuntimeLogDaemon":
        if not from_beginning and os.path.exists(self.log_path):
            with self._lock:
                self._offset = os.path.getsize(self.log_path)
        if self._thread is None:
            self._stopping.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stopping.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        self.flush()

    def flush(self) -> int:
        """Ship anything appended since the last poll; returns lines shipped."""
        with self._lock:
            if not os.path.exists(self.log_path):
                return 0
            size = os.path.getsize(self.log_path)
            if size < self._offset:  # truncated/rotated: restart from the top
                self._offset = 0
            if size == self._offset:
                return 0
            with open(self.log_path, "rb") as f:
                f.seek(self._offset)
                data = f.read(size - self._offset)
            # only complete lines ship; a partial trailing line waits
            last_nl = data.rfind(b"\n")
            if last_nl < 0:
                return 0
            self._offset += last_nl + 1
            lines = data[: last_nl + 1].decode(errors="replace").splitlines()
            shipped = 0
            for i in range(0, len(lines), self._batch):
                chunk = lines[i : i + self._batch]
                self._metrics.log({
                    "run_id": self.run_id,
                    "log_lines": chunk,
                    "line_start": self._line_no,
                })
                self._line_no += len(chunk)
                shipped += len(chunk)
            return shipped

    def _loop(self) -> None:
        while not self._stopping.is_set():
            try:
                self.flush()
            except OSError:
                pass
            time.sleep(self._poll)
