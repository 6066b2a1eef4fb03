"""Metrics and logs into a local JSONL sink.

Counterpart of ``fedml_tpu/core/mlops/metrics.py`` (the reference's
``mlops_metrics.py`` and the public ``mlops.log*`` calls). Records land in
``<log_file_dir>/run_<run_id>/metrics.jsonl`` through one cached append
handle (reopened when the sink moves or the file is rotated away), and
mirror to wandb where it is asked for and installed.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional

logger = logging.getLogger("fedml_tpu_torch.mlops")

_GLOBAL: "MLOpsMetrics | None" = None


class MLOpsMetrics:
    def __init__(self, args: Any = None, sink_dir: Optional[str] = None):
        run_id = str(getattr(args, "run_id", "0")) if args else "0"
        self.run_id = run_id
        self._dir = sink_dir or os.path.join(
            str(getattr(args, "log_file_dir", "") or ".fedml_logs"), f"run_{run_id}"
        )
        self._lock = threading.Lock()
        self._fh = None
        self._fh_path: "str | None" = None
        self._wandb = None
        if args is not None and bool(getattr(args, "enable_wandb", False)):
            try:
                import wandb

                self._wandb = wandb
            except ImportError:
                logger.warning("wandb requested but not installed; using local sink")

    def _handle(self):
        """Cached append handle (caller holds the lock). Reopens when the
        sink dir changed or the file was rotated/deleted underneath us —
        one stat per write instead of makedirs+open+close per write."""
        path = os.path.join(self._dir, "metrics.jsonl")
        if (self._fh is None or self._fh_path != path
                or not os.path.exists(path)):
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
            os.makedirs(self._dir, exist_ok=True)
            self._fh = open(path, "a")
            self._fh_path = path
        return self._fh

    def _write(self, kind: str, payload: Dict) -> None:
        rec = {"ts": time.time(), "kind": kind, **payload}
        with self._lock:
            f = self._handle()
            f.write(json.dumps(rec, default=str) + "\n")
            f.flush()
        if self._wandb is not None and kind == "metric":
            self._wandb.log(payload)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None
                self._fh_path = None

    def report_server_training_metric(self, metric: Dict) -> None:
        self._write("server_metric", metric)

    def report_client_training_metric(self, metric: Dict) -> None:
        self._write("client_metric", metric)

    def report_training_status(self, status: str, run_id: Any = None) -> None:
        self._write("status", {"status": status, "run_id": run_id or self.run_id})

    def log(self, metrics: Dict) -> None:
        self._write("metric", metrics)


def _global_sink() -> MLOpsMetrics:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = MLOpsMetrics()
    return _GLOBAL


def init(args: Any) -> MLOpsMetrics:
    global _GLOBAL
    _GLOBAL = MLOpsMetrics(args)
    return _GLOBAL


def log(metrics: Dict) -> None:
    """``fedml.mlops.log`` parity."""
    _global_sink().log(metrics)


def log_metric(metrics: Dict) -> None:
    _global_sink().log(metrics)


def log_artifact(path: str, artifact_name: str = None,
                 artifact_type: str = "general") -> str:
    """``fedml.mlops.log_artifact`` parity: copy the file into the sink's
    artifacts dir and record it. Returns the stored path."""
    import shutil

    sink = _global_sink()
    name = artifact_name or os.path.basename(path)
    dst_dir = os.path.join(sink._dir, "artifacts")
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, name)
    shutil.copy2(path, dst)
    sink._write("artifact", {"name": name, "type": artifact_type,
                             "path": dst})
    return dst


def log_model(model_name: str, params: Any) -> str:
    """``fedml.mlops.log_model`` parity: persist a params pytree into the
    artifacts dir (pickle-free serializer). Returns the stored path."""
    from fedml_tpu_torch.utils.serialization import safe_dumps

    sink = _global_sink()
    dst_dir = os.path.join(sink._dir, "artifacts")
    os.makedirs(dst_dir, exist_ok=True)
    dst = os.path.join(dst_dir, f"{model_name}.fedml")
    with open(dst, "wb") as f:
        f.write(safe_dumps(params))
    sink._write("model", {"name": model_name, "path": dst})
    return dst


def log_llm_record(record: Dict, record_type: str = "inference") -> None:
    """``fedml.mlops.log_llm_record`` parity: prompt/response telemetry."""
    _global_sink()._write("llm_record", {"record_type": record_type,
                                         **record})


def log_round_info(total_rounds: int, round_idx: int) -> None:
    _global_sink()._write("round_info", {"total_rounds": int(total_rounds),
                                         "round_idx": int(round_idx)})
