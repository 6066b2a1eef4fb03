"""The port's MLOps facades (``fedml_tpu_torch.core.mlops``,
``fedml_tpu_torch.mlops``) against the JAX package's, on the CPU: the
profiler events over the tracer (an unmatched end is an explicit zero, the
auto-flush threshold), the cached metrics handle and its records (equal
key for key, timestamps aside), the run-status machine's transitions, the
log daemon's tail and rotation, and the system-stats sampler with and
without ``psutil``."""
import json
import os
import sys
import time

import numpy as np
import pytest

from fedml_tpu.core.mlops import event as jevent
from fedml_tpu.core.mlops import log_daemon as jdaemon
from fedml_tpu.core.mlops import metrics as jmetrics
from fedml_tpu.core.mlops import status as jstatus
from fedml_tpu.core.mlops import system_stats as jstats
from fedml_tpu_torch import mlops as tmlops
from fedml_tpu_torch import telemetry as ttel
from fedml_tpu_torch.core.mlops import event as tevent
from fedml_tpu_torch.core.mlops import log_daemon as tdaemon
from fedml_tpu_torch.core.mlops import metrics as tmetrics
from fedml_tpu_torch.core.mlops import status as tstatus
from fedml_tpu_torch.core.mlops import system_stats as tstats


@pytest.fixture(autouse=True)
def _fresh_sinks():
    """No global sink or tracer leaks between tests."""
    ttel.reset_tracer()
    yield
    for mod in (tmetrics, jmetrics):
        if mod._GLOBAL is not None:
            mod._GLOBAL.close()
        mod._GLOBAL = None
    tmlops._event_singleton = None
    ttel.reset_tracer()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _sink_blob(sink_dir):
    out = []
    for name in sorted(os.listdir(sink_dir)):
        out.extend(_read_jsonl(os.path.join(sink_dir, name)))
    return out


def _no_ts(recs):
    return [{k: v for k, v in r.items() if k not in ("ts", "started", "ended", "mono",
                                                      "duration_ms", "trace_id", "span_id")}
            for r in recs]


# -- profiler events ------------------------------------------------------------
def test_unmatched_end_is_an_explicit_zero(tmp_path):
    out = []
    for mod, d in ((tevent, tmp_path / "t"), (jevent, tmp_path / "j")):
        ev = mod.MLOpsProfilerEvent(sink_path=str(d))
        ev.log_event_ended("never_started", 7)
        (span,) = ev.spans()
        assert span["duration_ms"] == 0.0
        assert span["event"] == "never_started" and span["edge_id"] == 7
        (rec,) = _read_jsonl(ev.flush())
        assert rec["attrs"] == {"edge_id": 7, "unmatched": True}
        assert rec["duration_ms"] == 0.0
        out.append(rec)
    assert sorted(out[0]) == sorted(out[1])


def test_matched_events_and_the_autoflush_threshold(tmp_path):
    names = {}
    for mod, d in ((tevent, tmp_path / "t"), (jevent, tmp_path / "j")):
        ev = mod.MLOpsProfilerEvent(sink_path=str(d), flush_threshold=5)
        for i in range(6):
            ev.log_event_started("step", i)
            ev.log_event_ended("step", i)
        # the buffer crossed the threshold: spans on disk without flush()
        assert len(_read_jsonl(d / "events.jsonl")) == 5
        ev.flush()
        recs = _read_jsonl(d / "events.jsonl")
        assert len(recs) == 6 and all(r["duration_ms"] >= 0 for r in recs)
        names[mod] = _no_ts(recs)
    assert names[tevent] == names[jevent]


@pytest.mark.parametrize("mod", [tevent, jevent], ids=["port", "jax"])
def test_events_off(mod, tmp_path):
    import types

    args = types.SimpleNamespace(run_id="e", log_file_dir=str(tmp_path),
                                 sys_perf_profiling=False)
    ev = mod.MLOpsProfilerEvent(args)
    ev.log_event_started("round", 0)
    ev.log_event_ended("round", 0)
    assert ev.spans() == [] and ev.flush() is None
    assert not os.path.exists(tmp_path / "run_e")


def test_event_sink_follows_the_run_dir_layout(tmp_path):
    import types

    args = types.SimpleNamespace(run_id="r5", log_file_dir=str(tmp_path))
    ev = tevent.MLOpsProfilerEvent(args)
    ev.log_event_started("round", 0)
    ev.log_event_ended("round", 0)
    assert ev.flush() == os.path.join(str(tmp_path), "run_r5", "events.jsonl")
    assert ev.start_trace() is False and ev.stop_trace() is None
    args.jax_trace_dir = str(tmp_path / "trace")
    with pytest.raises(NotImplementedError, match="A12b"):
        tevent.MLOpsProfilerEvent(args).start_trace()


def test_mlops_event_context_manager(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # the default sink is ./.fedml_logs/run_0
    with tmlops.event("sync", 3):
        pass
    (span,) = tmlops._events().spans()
    assert span["event"] == "sync" and span["edge_id"] == 3 and span["duration_ms"] >= 0


# -- the metrics sink -----------------------------------------------------------------
def test_metrics_sink_caches_its_handle(tmp_path):
    m = tmetrics.MLOpsMetrics(sink_dir=str(tmp_path))
    m.log({"a": 1})
    fh = m._fh
    m.log({"a": 2})
    assert m._fh is fh, "the append handle is reused across writes"
    path = tmp_path / "metrics.jsonl"
    assert len(_read_jsonl(path)) == 2
    os.remove(path)  # rotated away: the next write reopens
    m.log({"a": 3})
    assert m._fh is not fh
    (rec,) = _read_jsonl(path)
    assert rec["a"] == 3
    m.close()
    assert m._fh is None


def test_metrics_records_equal_the_references(tmp_path):
    import types

    from fedml_tpu.utils.serialization import safe_dumps as jdumps

    params = {"Dense_0": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3),
                          "bias": np.ones(3, np.float32)}}
    art = tmp_path / "note.txt"
    art.write_text("hello")
    out = {}
    for mod, side in ((tmetrics, "t"), (jmetrics, "j")):
        args = types.SimpleNamespace(run_id="m", log_file_dir=str(tmp_path / side))
        sink = mod.init(args)
        sink.report_server_training_metric({"round": 0, "test_acc": 0.5})
        sink.report_client_training_metric({"client": 1, "train_loss": 1.25})
        sink.report_training_status("RUNNING")
        mod.log({"round": 1, "test_loss": 0.75})
        mod.log_metric({"lr": 0.1})
        stored = mod.log_artifact(str(art), artifact_type="text")
        model = mod.log_model("global", params)
        mod.log_llm_record({"prompt": "p", "response": "r"})
        mod.log_round_info(10, 3)
        sink.close()
        recs = _read_jsonl(tmp_path / side / "run_m" / "metrics.jsonl")
        for r in recs:
            r.pop("ts")
            r.pop("path", None)
        out[side] = recs
        assert open(stored).read() == "hello"
        with open(model, "rb") as f:
            out[side + "_model"] = f.read()
    assert out["t"] == out["j"]
    assert [r["kind"] for r in out["t"]] == [
        "server_metric", "client_metric", "status", "metric", "metric", "artifact", "model",
        "llm_record", "round_info"]
    assert out["t_model"] == out["j_model"] == jdumps(params)


def test_global_sink_default_layout(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tmlops.log({"x": 1})
    (rec,) = _read_jsonl(tmp_path / ".fedml_logs" / "run_0" / "metrics.jsonl")
    assert rec["kind"] == "metric" and rec["x"] == 1


# -- the run-status machine ---------------------------------------------------------
def test_status_transitions_equal_the_references():
    states = [v for k, v in vars(jstatus.RunStatus).items()
              if k.isupper() and isinstance(v, str)]
    assert states == [v for k, v in vars(tstatus.RunStatus).items()
                      if k.isupper() and isinstance(v, str)]
    assert tstatus.RunStatus.TERMINAL == jstatus.RunStatus.TERMINAL
    for src in states:
        for dst in states:
            assert tstatus.RunStatus.can_transition(src, dst) == \
                jstatus.RunStatus.can_transition(src, dst), (src, dst)


def test_status_machine_walk_and_sink():
    for mod in (tstatus, jstatus):
        seen = []
        sm = mod.RunStatusMachine("r1", sink=seen.append)
        S = mod.RunStatus
        assert sm.transition(S.QUEUED) and sm.transition(S.RUNNING)
        assert not sm.transition(S.IDLE)  # illegal: a no-op
        assert sm.transition(S.RUNNING)  # same state: applied, not recorded
        assert sm.transition(S.FINISHED) and sm.is_terminal
        assert [e["to"] for e in seen] == ["QUEUED", "RUNNING", "FINISHED"]
        raising = mod.RunStatusMachine("r2", sink=lambda e: 1 / 0)
        assert raising.transition(S.RUNNING)  # a raising sink never breaks it


# -- the log daemon ----------------------------------------------------------------------
def test_log_daemon_tails_appended_lines(tmp_path):
    log = tmp_path / "run.log"
    sink = tmp_path / "sink"
    log.write_text("line-1\nline-2\n")
    d = tdaemon.MLOpsRuntimeLogDaemon("r42", str(log), sink_dir=str(sink), poll_interval=0.05)
    d.start()
    time.sleep(0.2)
    with open(log, "a") as f:
        f.write("line-3\npartial")  # no trailing newline: held back
    time.sleep(0.3)
    with open(log, "a") as f:
        f.write("-done\n")
    time.sleep(0.3)
    d.stop()
    entries = [e for e in _sink_blob(str(sink)) if "log_lines" in e]
    assert [x for e in entries for x in e["log_lines"]] == [
        "line-1", "line-2", "line-3", "partial-done"]
    assert all(e["run_id"] == "r42" for e in entries)


def test_log_daemon_rotation_and_batches_equal_the_references(tmp_path):
    out = {}
    for mod, side in ((tdaemon, "t"), (jdaemon, "j")):
        log = tmp_path / f"{side}.log"
        sink = tmp_path / f"sink_{side}"
        log.write_text("".join(f"l{i}\n" for i in range(5)))
        d = mod.MLOpsRuntimeLogDaemon("r1", str(log), sink_dir=str(sink), batch_lines=2)
        assert d.flush() == 5
        assert d.flush() == 0
        log.write_text("c\n")  # truncated or rotated: from the top again
        assert d.flush() == 1
        d.start(from_beginning=False)
        d.stop()
        out[side] = _no_ts(_sink_blob(str(sink)))
    assert out["t"] == out["j"]
    assert [e["line_start"] for e in out["t"]] == [0, 2, 4, 5]


# -- system stats ------------------------------------------------------------------------
def test_system_stats_with_psutil(tmp_path):
    pytest.importorskip("psutil")
    stats = tstats.sample_system_stats()
    assert {"cpu_percent", "mem_percent", "mem_used_gb"} <= set(stats)
    assert sorted(stats) == sorted(jstats.sample_system_stats())
    s = tstats.SysStatsSampler(sink_dir=str(tmp_path / "sink"), interval_s=0.05, run_id="r9")
    s.start()
    time.sleep(0.3)
    s.stop()
    assert s.samples >= 2
    blob = _sink_blob(str(tmp_path / "sink"))
    assert all(e["run_id"] == "r9" and "sys_stats" in e and "devices" in e for e in blob)


def test_system_stats_without_psutil(monkeypatch):
    monkeypatch.setitem(sys.modules, "psutil", None)  # `import psutil` fails
    for mod in (tstats, jstats):
        stats = mod.sample_system_stats()
        assert stats["psutil"] == "unavailable" and "cpu_percent" not in stats


def test_device_stats(monkeypatch):
    import torch

    if not torch.cuda.is_available():
        assert tstats.sample_device_stats() == []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda i: 3 * 2**30)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda i: 4 * 2**30)

    class Props:
        total_memory = 80 * 2**30

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda i: Props())
    (dev,) = tstats.sample_device_stats()
    assert dev == {"id": 0, "kind": "NVIDIA H100 80GB HBM3", "platform": "gpu",
                   "hbm_used_gb": 3.0, "hbm_reserved_gb": 4.0, "hbm_limit_gb": 80.0}
