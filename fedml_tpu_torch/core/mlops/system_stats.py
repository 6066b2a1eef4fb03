"""System and device sampling into the metrics sink.

Counterpart of ``fedml_tpu/core/mlops/system_stats.py`` (the reference's
``mlops_device_perfs.py``): host CPU, memory and network from ``psutil``
where it is installed (else the sample says ``"psutil": "unavailable"``),
and each CUDA device's allocated and reserved memory from
``torch.cuda``, sampled on a daemon thread into the JSONL sink.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

import torch

from fedml_tpu_torch.core.mlops.metrics import MLOpsMetrics


def sample_system_stats() -> Dict:
    out: Dict = {"ts": time.time()}
    try:
        import psutil

        out["cpu_percent"] = psutil.cpu_percent(interval=None)
        vm = psutil.virtual_memory()
        out["mem_percent"] = vm.percent
        out["mem_used_gb"] = round(vm.used / 2**30, 3)
        try:
            io = psutil.net_io_counters()
            out["net_sent_mb"] = round(io.bytes_sent / 2**20, 2)
            out["net_recv_mb"] = round(io.bytes_recv / 2**20, 2)
        except Exception:
            pass
    except Exception:
        out["psutil"] = "unavailable"
    return out


def sample_device_stats() -> List[Dict]:
    """One entry a CUDA device (none without CUDA); reading memory
    counters does not synchronise the device."""
    devices = []
    try:
        for i in range(torch.cuda.device_count()):
            entry: Dict = {"id": i, "kind": torch.cuda.get_device_name(i),
                           "platform": "gpu"}
            try:
                entry["hbm_used_gb"] = round(torch.cuda.memory_allocated(i) / 2**30, 3)
                entry["hbm_reserved_gb"] = round(torch.cuda.memory_reserved(i) / 2**30, 3)
                entry["hbm_limit_gb"] = round(
                    torch.cuda.get_device_properties(i).total_memory / 2**30, 3)
            except Exception:
                pass
            devices.append(entry)
    except Exception:
        pass
    return devices


class SysStatsSampler:
    """Periodic sampler into the metrics sink (``{"sys_stats": ...,
    "devices": ...}``)."""

    def __init__(self, args: Any = None, sink_dir: Optional[str] = None,
                 interval_s: float = 10.0, run_id: str = "0"):
        self.run_id = str(run_id)
        self._metrics = MLOpsMetrics(args, sink_dir=sink_dir)
        self._interval = float(interval_s)
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()
        self.samples = 0
        self._lock = threading.Lock()

    def sample_once(self) -> Dict:
        entry = {
            "run_id": self.run_id,
            "sys_stats": sample_system_stats(),
            "devices": sample_device_stats(),
        }
        self._metrics.log(entry)
        with self._lock:
            self.samples += 1
        return entry

    def start(self) -> "SysStatsSampler":
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

    def _loop(self) -> None:
        while not self._stopping.is_set():
            try:
                self.sample_once()
            except Exception:
                pass
            self._stopping.wait(self._interval)
