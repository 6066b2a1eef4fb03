"""The port's run health (``fedml_tpu_torch.telemetry.health``'s
``ClientHealthTracker``, ``telemetry.doctor`` and the records the sp engine,
the cross-silo server, secure aggregation, the integrity rings and the tree
write) against the JAX package's, on the CPU (``tests/test_run_health.py``
mirrored).

What must be equal, and how:

* the tracker is plain Python: the same ``observe``/``heartbeat``/
  ``finish_round`` sequence gives equal ``client_health`` records (``ts``
  aside), ``flagged()``, ``snapshot()``, gauges and counters, exactly;
* an sp run (the reference's acceptance config: a slow and a noisy client)
  gives the same (round, client) records with the same fields None, update
  norms within ``NORM_RTOL``, the same flags, and a doctor naming the same
  clients, plain and under int8;
* each package's doctor over the other's run dir gives the other's result,
  dict and text, ``tracepath`` (the critical path's) included;
* the cross-silo, secagg, integrity, tree, scheduler, comm-manager and
  async-server records equal the reference's in kind, event, fields,
  rounds and clients; the doctor's secagg counters are equal (C5: the port
  once counted ``secagg/phases``);
* the adaptive deadline armed from the tracker is the one the server armed
  from its latency EWMA, and a durable restart with an eviction counts each
  ``resilience/*`` counter once.
"""
import copy
import json
import math
import os
import signal
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import telemetry as jtel
from fedml_tpu.telemetry import doctor as jdoctor
from fedml_tpu.telemetry import health as jhealth
from fedml_tpu_torch import cli as tcli
from fedml_tpu_torch import telemetry as ttel
from fedml_tpu_torch.telemetry import doctor as tdoctor
from fedml_tpu_torch.telemetry import health as thealth
from fedml_tpu_torch.telemetry.profiling import catalog as tcat
from fedml_tpu_torch.telemetry.profiling import trace as ttrace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SLOW_CLIENT = 1
NOISY_CLIENT = 2
SLOW_SLEEP_S = 0.15
NORM_RTOL = 1e-4  # an update norm: the same f32 parameters, summed in another order


def _reset_port():
    ttel.reset_registry()
    ttel.reset_tracer()
    ttel.reset_flight_recorder()
    tcat.reset_catalog()
    ttrace.reset_trace_controller()
    thealth.reset_health_log()


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    """Each test starts and ends with fresh port telemetry (the JAX
    package's is reset by the conftest)."""
    _reset_port()
    yield
    _reset_port()


def _read_jsonl(path):
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _no_ts(obj):
    """``obj`` with every ``ts`` key dropped (records of two runs differ in
    their timestamps alone)."""
    if isinstance(obj, dict):
        return {k: _no_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_no_ts(v) for v in obj]
    return obj


def _records(run_dir, kind):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in _read_jsonl(os.path.join(run_dir, "health.jsonl"))
            if e.get("kind") == kind]


# -- the tracker -------------------------------------------------------------------
def _script(case):
    """A seeded sequence of tracker calls: ("obs", client, round, latency,
    norm, loss, heartbeat), ("hb", client, fields) and ("finish", round)."""
    rng = np.random.default_rng({"cohort3": 0, "cohort5": 1, "ties": 2, "nonfinite": 3}[case])
    n = 3 if case == "cohort3" else 5
    steps = []
    for r in range(5):
        for c in range(n):
            lat = 0.1 + 0.01 * float(rng.random())
            norm = 1.0 + 0.05 * float(rng.random())
            loss = 0.5 + 0.1 * float(rng.random())
            if case == "ties":
                lat, norm, loss = 0.1, 1.0, 0.5  # every value tied: MAD 0
            if c == 1:
                lat *= 4.0  # the straggler
            if c == 2 and case != "ties":
                norm *= 30.0  # the anomaly
            hb = {"mem_bytes": 1000 + c}
            if case == "nonfinite" and r == 2:
                if c == 0:
                    lat = float("nan")
                if c == 3:
                    loss = float("inf")
                if c == 4:
                    hb = {"mem_bytes": float("nan")}
            steps.append(("obs", c, r, lat, norm, loss, hb if c % 2 == 0 else None))
            if c == 1:
                steps.append(("hb", c, {"mem_bytes": 2000, "train_ms": 3.0}))
        steps.append(("finish", r))
    return steps


def _drive(pkg, steps):
    reg = pkg.MetricsRegistry()
    tr = pkg.ClientHealthTracker(registry=reg)
    outs = []
    for s in steps:
        if s[0] == "obs":
            _, c, r, lat, norm, loss, hb = s
            tr.observe(c, r, latency_s=lat, update_norm=norm, train_loss=loss, heartbeat=hb)
        elif s[0] == "hb":
            tr.heartbeat(s[1], s[2])
        else:
            outs.append(tr.finish_round(s[1]))
    snap = [m for m in reg.snapshot() if m["name"].startswith("health/")]
    return tr, outs, snap


@pytest.mark.parametrize("case", ["cohort3", "cohort5", "ties", "nonfinite"])
def test_tracker_equals_the_reference(case, tmp_path):
    """Records, flags, snapshot, gauges and counters equal, exactly; the
    records land in each package's ``health.jsonl`` with the same keys."""
    steps = _script(case)
    jtel.configure(str(tmp_path / "jax"))
    ttel.configure(str(tmp_path / "port"))
    jtr, jouts, jsnap = _drive(jtel, steps)
    ttr, touts, tsnap = _drive(ttel, steps)
    assert touts == jouts
    assert ttr.flagged() == jtr.flagged()
    assert ttr.snapshot() == jtr.snapshot()
    assert tsnap == jsnap
    for c in range(5):
        assert ttr.straggler_score(c) == jtr.straggler_score(c)
        assert ttr.anomaly_score(c) == jtr.anomaly_score(c)
    assert (_records(str(tmp_path / "port"), "client_health")
            == _records(str(tmp_path / "jax"), "client_health"))
    dropped = {m["name"]: m.get("value") for m in tsnap}.get("health/nonfinite_dropped", 0)
    assert dropped == (3 if case == "nonfinite" else 0)
    if case == "cohort5":
        assert ttr.flagged() == {"stragglers": [1], "anomalies": [2]}


@pytest.mark.parametrize("values", [
    {}, {0: 1.0}, {0: 1.0, 1: 2.0, 2: 3.0}, {0: 1.0, 1: 1.0, 2: 1.0, 3: 1.0},
    {0: 1.0, 1: 1.0, 2: 1.0, 3: 9.0}, {0: 0.3, 1: 0.1, 2: 0.7, 3: 0.2, 4: 40.0},
])
def test_robust_z_and_median_equal_the_reference(values):
    assert thealth.robust_z(values) == jhealth.robust_z(values)
    if values:
        assert thealth._median(list(values.values())) == jhealth._median(list(values.values()))


# -- the sp acceptance run, both packages -----------------------------------------
def _sp_cfg(tmp, run_id, extra=None):
    return {
        "common_args": {"training_type": "simulation", "random_seed": 0,
                        "run_id": run_id, "log_file_dir": str(tmp)},
        "data_args": {"dataset": "synthetic", "partition_method": "hetero",
                      "partition_alpha": 0.5, "train_size": 200,
                      "test_size": 80, "class_num": 3, "feature_dim": 10},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 4, "client_num_per_round": 4,
                       "comm_round": 5, "epochs": 1,
                       "batch_size": 16, "learning_rate": 0.3, **(extra or {})},
    }


def _jax_sp_api(cfg):
    from fedml_tpu import device as device_mod
    from fedml_tpu import models as models_mod
    from fedml_tpu.arguments import load_arguments_from_dict
    from fedml_tpu.data import load_federated
    from fedml_tpu.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI

    class FaultyTrainer(ClassificationTrainer):
        def train(self, params, train_data, device, args):
            new_params, metrics = super().train(params, train_data, device, args)
            if self.id == SLOW_CLIENT:
                time.sleep(SLOW_SLEEP_S)
            if self.id == NOISY_CLIENT:
                new_params = jax.tree.map(lambda x: x + 40.0 * jax.numpy.ones_like(x),
                                          new_params)
                metrics = {**metrics, "train_loss": 1e4}
            return new_params, metrics

    args = fedml_tpu.init(load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = load_federated(args)
    model = models_mod.create(args, ds.class_num)
    return FedAvgAPI(args, device_mod.get_device(args), ds, model,
                     client_trainer=FaultyTrainer(model, args))


def _port_sp_api(cfg, init_from):
    """The port's engine with the reference's initial weights."""
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.convert import from_flax_params
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    class FaultyTrainer(ClassificationTrainer):
        def train(self, params, train_data, device, args):
            new_params, metrics = super().train(params, train_data, device, args)
            if self.id == SLOW_CLIENT:
                time.sleep(SLOW_SLEEP_S)
            if self.id == NOISY_CLIENT:
                new_params = {k: v + 40.0 for k, v in new_params.items()}
                metrics = {**metrics, "train_loss": 1e4}
            return new_params, metrics

    args = fedml_tpu_torch.init(load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = load_federated(args)
    model = create(args, ds.class_num)
    api = FedAvgAPI(args, "cpu", ds, model, client_trainer=FaultyTrainer(model, args))
    api.global_params = from_flax_params(jax.tree.map(np.asarray, init_from))
    return api


@pytest.fixture(scope="module")
def sp_dirs(tmp_path_factory):
    """The acceptance run in each package, plain and under int8:
    {codec: (port run dir, JAX run dir)}."""
    base = tmp_path_factory.mktemp("sp_health")
    out = {}
    for codec in ("plain", "int8"):
        extra = {"compression": "int8"} if codec == "int8" else None
        _reset_port()
        japi = _jax_sp_api(_sp_cfg(base / "jax", f"h_{codec}", extra))
        init = japi.global_params
        _port_sp_api(_sp_cfg(base / "port", f"h_{codec}", extra), init).train()
        japi.train()
        jtel.flush_run()
        out[codec] = (str(base / "port" / f"run_h_{codec}"),
                      str(base / "jax" / f"run_h_{codec}"))
    _reset_port()
    return out


def _by_key(records):
    return {(r["round"], str(r["client"])): r for r in records}


@pytest.mark.parametrize("codec", ["plain", "int8"])
def test_sp_client_health_equals_the_reference(codec, sp_dirs):
    port_dir, jax_dir = sp_dirs[codec]
    port, ref = (_by_key(_records(d, "client_health")) for d in (port_dir, jax_dir))
    assert sorted(port) == sorted(ref) == sorted(
        (r, str(c)) for r in range(5) for c in range(4))
    for k, want in ref.items():
        got = port[k]
        assert sorted(got) == sorted(want)
        assert [f for f in want if want[f] is None] == [f for f in got if got[f] is None], k
        # int8 after round 0: the two packages' global models agree to f32
        # rounding, not bit for bit, so the encode's stochastic rounding may
        # flip a code; a flipped code moves the norm by at most one step,
        # itself at most the norm / 127
        slack = want["update_norm"] / 127 if codec == "int8" and k[0] > 0 else 0.0
        assert (abs(got["update_norm"] - want["update_norm"])
                <= NORM_RTOL * want["update_norm"] + slack), (
            k, got["update_norm"], want["update_norm"])
        if want["train_loss"] is not None:
            assert math.isclose(got["train_loss"], want["train_loss"], rel_tol=1e-4), k
    for flag in ("flagged_straggler", "flagged_anomaly"):
        assert ({k for k, r in port.items() if r[flag]}
                == {k for k, r in ref.items() if r[flag]}), flag
    jd, td = jtel.build_doctor(jax_dir), ttel.build_doctor(port_dir)
    for key in ("stragglers", "anomalies"):
        assert [r["client"] for r in td[key]] == [r["client"] for r in jd[key]], key
    assert [r["client"] for r in td["stragglers"]] == [str(SLOW_CLIENT)]
    assert [r["client"] for r in td["anomalies"]] == [str(NOISY_CLIENT)]

    def named(verdict):
        return sorted(v.split(":")[0] for v in verdict if v.startswith("client "))

    assert named(td["verdict"]) == named(jd["verdict"])
    mem = [e for e in _records(port_dir, "mem_sample") if e.get("phase") == "train"]
    assert {e["round"] for e in mem} == set(range(5))


@pytest.mark.parametrize("codec", ["plain", "int8"])
@pytest.mark.parametrize("run", ["jax", "port"])
def test_doctor_reads_either_packages_run_dir(run, codec, sp_dirs):
    """Each package's doctor over the other's run dir gives the other's
    result, dict and text, the critical path's ``tracepath`` included."""
    run_dir = sp_dirs[codec][0 if run == "port" else 1]
    jd, td = jdoctor.build_doctor(run_dir), tdoctor.build_doctor(run_dir)
    assert td == jd
    assert td["tracepath"]["rounds_traced"] == 5
    assert tdoctor.format_doctor(td) == jdoctor.format_doctor(jd)
    # a doctor dict of either package renders alike in the other's format
    assert tdoctor.format_doctor(jd) == jdoctor.format_doctor(jd)
    assert td["schema"] == "fedml_tpu.telemetry.doctor/v1"


# -- the CLI -----------------------------------------------------------------------------
def test_cli_doctor_text_json_and_exit_codes(sp_dirs, tmp_path, capsys):
    port_dir = sp_dirs["plain"][0]
    assert tcli.main(["telemetry", "doctor", port_dir]) == 0
    out = capsys.readouterr().out
    assert f"client {SLOW_CLIENT} is a straggler" in out
    assert "anomalous clients" in out
    assert tcli.main(["telemetry", "doctor", port_dir, "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = json.loads(json.dumps(tdoctor.build_doctor(port_dir), sort_keys=True, default=str))
    assert got == want
    # a threshold no client reaches flags nobody
    assert tcli.main(["telemetry", "doctor", port_dir, "--json",
                      "--straggler-threshold", "1e9", "--anomaly-threshold", "1e9"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["stragglers"] == [] and got["anomalies"] == []
    empty = tmp_path / "empty"
    empty.mkdir()
    assert tcli.main(["telemetry", "doctor", str(empty)]) == 1
    assert "no telemetry data" in capsys.readouterr().out
    assert tcli.main(["telemetry", "report", port_dir]) == 0
    assert "client health" in capsys.readouterr().out


# -- degradation and the crash context ---------------------------------------------
def _degraded_dirs(tmp_path):
    dirs = {}
    dirs["empty"] = tmp_path / "empty"
    dirs["empty"].mkdir()
    dirs["truncated"] = tmp_path / "truncated"
    dirs["truncated"].mkdir()
    with open(dirs["truncated"] / "spans.jsonl", "w") as f:
        f.write('{"name": "round/0/train", "duration_ms": 5.0, '
                '"started": 1.0, "ended": 1.005}\n')
        f.write('{"name": "round/1/train", "dur')
    with open(dirs["truncated"] / "telemetry.jsonl", "w") as f:
        f.write("not json at all\n")
    with open(dirs["truncated"] / "health.jsonl", "w") as f:
        f.write('{"kind": "client_health", "round": 0, "cli')
    dirs["metrics_only"] = tmp_path / "metrics_only"
    reg = ttel.MetricsRegistry()
    reg.counter("comm/raw_bytes").inc(1000)
    reg.gauge("mem/live_buffer_bytes", labels={"phase": "train"}).set(5.0)
    reg.flush_jsonl(str(dirs["metrics_only"]))
    dirs["partial"] = tmp_path / "partial"
    ttel.FlightRecorder().dump(run_dir=str(dirs["partial"]), reason="manual")
    dirs["span_fallback"] = tmp_path / "span_fallback"
    dirs["span_fallback"].mkdir()
    with open(dirs["span_fallback"] / "spans.jsonl", "w") as f:
        for rnd in range(4):
            for cid, d in ((0, 900.0), (1, 50.0), (2, 40.0)):
                f.write(json.dumps({"name": f"round/{rnd}/client/{cid}/train",
                                    "trace_id": "t", "span_id": f"s{rnd}{cid}",
                                    "parent_id": None, "started": float(rnd),
                                    "ended": rnd + d / 1e3, "duration_ms": d}) + "\n")
    return {k: str(v) for k, v in dirs.items()}


@pytest.mark.parametrize("case", ["empty", "truncated", "metrics_only", "partial",
                                  "span_fallback"])
def test_doctor_degrades_like_the_reference(case, tmp_path):
    """Partial run dirs triage into the reference's notes, never an
    exception; the CLI exits 1 only on a dir with no telemetry at all."""
    run_dir = _degraded_dirs(tmp_path)[case]
    jd, td = jdoctor.build_doctor(run_dir), tdoctor.build_doctor(run_dir)
    assert td == jd
    assert tdoctor.format_doctor(td) == jdoctor.format_doctor(jd)
    assert "no data" in tdoctor.format_doctor(td)
    assert ("run" in td["notes"]) == (case == "empty")
    if case == "span_fallback":
        assert td["span_stragglers"][0]["client"] == "0"
        assert any("client 0 was the slowest" in v for v in td["verdict"])


def test_sigterm_crash_context_names_death_and_checkpoint(tmp_path):
    """kill -TERM mid-run of a port sp run: the flight recorder's dump says
    sigterm and its last checkpoint round is durable; both doctors read it
    alike."""
    ckpt_dir = str(tmp_path / "ckpts")
    script = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {REPO!r})
        import fedml_tpu_torch
        from fedml_tpu_torch.arguments import load_arguments_from_dict
        from fedml_tpu_torch.data.data_loader import load_federated
        from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
        from fedml_tpu_torch.models.model_hub import create
        from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

        class SlowTrainer(ClassificationTrainer):
            def train(self, *a, **kw):
                out = super().train(*a, **kw)
                time.sleep(0.06)
                return out

        cfg = {{
            "common_args": {{"training_type": "simulation", "random_seed": 0,
                             "run_id": "sigterm", "log_file_dir": {str(tmp_path)!r}}},
            "data_args": {{"dataset": "synthetic", "train_size": 120, "test_size": 40,
                           "class_num": 3, "feature_dim": 8}},
            "model_args": {{"model": "lr"}},
            "train_args": {{"federated_optimizer": "FedAvg", "client_num_in_total": 3,
                            "client_num_per_round": 3, "comm_round": 300, "epochs": 1,
                            "batch_size": 16, "learning_rate": 0.3,
                            "frequency_of_the_test": 1000,
                            "checkpoint_dir": {ckpt_dir!r}, "checkpoint_frequency": 1}},
        }}
        args = fedml_tpu_torch.init(load_arguments_from_dict(cfg))
        ds = load_federated(args)
        model = create(args, ds.class_num)
        FedAvgAPI(args, "cpu", ds, model, client_trainer=SlowTrainer(model, args)).train()
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    from fedml_tpu_torch.core.checkpoint import RoundCheckpointer

    try:
        deadline = time.time() + 150
        while time.time() < deadline:
            if os.path.isdir(ckpt_dir) and len(RoundCheckpointer(ckpt_dir).saved_rounds()) >= 2:
                break
            if proc.poll() is not None:
                pytest.fail(f"run exited early: {proc.communicate()[1].decode()[-2000:]}")
            time.sleep(0.05)
        else:
            pytest.fail("no checkpoint appeared before the deadline")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == -signal.SIGTERM
    run_dir = str(tmp_path / "run_sigterm")
    events = _read_jsonl(os.path.join(run_dir, "flight_recorder.jsonl"))
    assert events[0]["reason"] == "sigterm"
    last = [e for e in events if e.get("kind") == "checkpoint"][-1]["round"]
    durable = RoundCheckpointer(ckpt_dir).latest_round()
    assert last in (durable, durable - 1)
    jd, td = jdoctor.build_doctor(run_dir), tdoctor.build_doctor(run_dir)
    assert td["crash"] == jd["crash"]
    assert td["crash"]["reason"] == "sigterm"
    assert td["crash"]["last_checkpoint_round"] == last
    assert any("died" in v and "sigterm" in v for v in td["verdict"])
    assert td == jd


# -- scheduler records ---------------------------------------------------------------
def test_sched_event_equals_the_reference(tmp_path):
    from fedml_tpu.scheduler.supervision import sched_event as jsched
    from fedml_tpu_torch.scheduler.supervision import sched_event as tsched

    jtel.configure(str(tmp_path / "jax"))
    ttel.configure(str(tmp_path / "port"))
    for fn in (jsched, tsched):
        fn("crash_loop", run_id="r1", attempts=3, reason="rc=7 three times")
        fn("node_lost", node="n2", deadline_s=5.0)
    assert (_records(str(tmp_path / "port"), "sched_event")
            == _records(str(tmp_path / "jax"), "sched_event"))

    def ring(pkg):
        return [{k: v for k, v in e.items() if k != "ts"}
                for e in pkg.get_flight_recorder().snapshot() if e["kind"] == "sched_event"]

    assert ring(ttel) == ring(jtel) and len(ring(ttel)) == 2
    jd = jdoctor.build_doctor(str(tmp_path / "jax"))
    td = tdoctor.build_doctor(str(tmp_path / "port"))
    assert _no_ts(td["jobplane"]) == _no_ts(jd["jobplane"])
    assert [v for v in td["verdict"] if "CRASH-LOOPED" in v or "LOST" in v] == [
        v for v in jd["verdict"] if "CRASH-LOOPED" in v or "LOST" in v]


# -- cross-silo ------------------------------------------------------------------------
def _cs_health_cfg(tmp, run_id):
    return {
        "common_args": {"training_type": "cross_silo", "random_seed": 0,
                        "run_id": run_id, "log_file_dir": str(tmp)},
        "data_args": {"dataset": "synthetic", "train_size": 300,
                      "test_size": 60, "class_num": 4, "feature_dim": 12},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg",
                       "client_num_in_total": 3, "client_num_per_round": 3,
                       "comm_round": 2, "epochs": 1, "batch_size": 32,
                       "learning_rate": 0.3},
    }


def test_cross_silo_server_scores_clients_like_the_reference(tmp_path):
    """The reference's ``test_cross_silo_server_scores_clients`` config in
    process in both packages: a ``client_health`` record for every client and
    round with the same fields None, ``aggregate`` memory samples every
    round, and nobody flagged."""
    from fedml_tpu import models as jmodels
    from fedml_tpu.arguments import load_arguments_from_dict as jload
    from fedml_tpu.cross_silo.run_inproc import run_cross_silo_inproc as jrun
    from fedml_tpu.data import load_federated as jdata
    from fedml_tpu_torch.arguments import load_arguments_from_dict as tload
    from fedml_tpu_torch.cross_silo.run_inproc import run_cross_silo_inproc as trun
    from fedml_tpu_torch.data.data_loader import load_federated as tdata
    from fedml_tpu_torch.models.model_hub import create

    args = fedml_tpu.init(jload(_cs_health_cfg(tmp_path / "jax", "cs_health")))
    ds = jdata(args)
    assert jrun(args, ds, jmodels.create(args, ds.class_num), timeout=120) is not None
    args = fedml_tpu_torch.init(tload(_cs_health_cfg(tmp_path / "port", "cs_health")))
    ds = tdata(args)
    assert trun(args, ds, create(args, ds.class_num), device="cpu", timeout=120) is not None
    recs = {}
    for side in ("jax", "port"):
        run_dir = str(tmp_path / side / "run_cs_health")
        ch = _records(run_dir, "client_health")
        recs[side] = {(e["round"], str(e["client"])): e for e in ch}
        assert sorted(recs[side]) == [(r, c) for r in (0, 1) for c in ("1", "2", "3")]
        assert all(e["latency_ms"] is not None and e["update_norm"] is not None for e in ch)
        mem = [e for e in _records(run_dir, "mem_sample") if e.get("phase") == "aggregate"]
        assert {e["round"] for e in mem} == {0, 1}
        d = (tdoctor if side == "port" else jdoctor).build_doctor(run_dir)
        assert not d["stragglers"] and not d["anomalies"]
    for k, want in recs["jax"].items():
        got = recs["port"][k]
        assert sorted(got) == sorted(want)
        assert [f for f in want if want[f] is None] == [f for f in got if got[f] is None], k


class _ParentLatencyEWMA:
    """The cross-silo server's latency EWMA before the tracker replaced it
    (each client's broadcast-to-upload latency, folded at the round close,
    α 0.4): the adaptive deadline's input, kept here to hold the tracker's
    ``latency_ewma_s`` to it."""

    def __init__(self, alpha=0.4):
        self.alpha, self._pending, self.ewma = alpha, {}, {}

    def observe(self, client_id, round_idx, latency_s):
        if math.isfinite(latency_s):
            self._pending.setdefault(int(round_idx), {})[client_id] = float(latency_s)

    def finish_round(self, round_idx):
        for cid, lat in self._pending.pop(int(round_idx), {}).items():
            prev = self.ewma.get(cid)
            self.ewma[cid] = lat if prev is None else (
                self.alpha * lat + (1 - self.alpha) * prev)


def test_adaptive_deadline_from_the_tracker_is_unchanged():
    """Per round, the deadline the server arms from the tracker's
    ``latency_ewma_s`` equals the one the latency EWMA gave, for the same
    latencies (a NaN among them), with and without a static ceiling hit."""
    import test_torch_cross_silo as cs
    from fedml_tpu_torch.resilience import adaptive_deadline_s

    cfg = cs._cfg(round_deadline_s=30.0, round_deadline_multiplier=4.0,
                  round_deadline_grace_s=0.5, round_deadline_min_s=1.0)
    port = cs._port_fed(cfg, cs._jax_init(cs._jax_fed(cfg)))
    mgr = port.server.manager
    armed = []
    mgr._deadline.arm = lambda r, timeout: armed.append(timeout)
    old = _ParentLatencyEWMA()
    rng = np.random.default_rng(5)
    want = []
    for r in range(6):
        for c in (1, 2, 3):
            lat = float(rng.uniform(0.05, 12.0)) if not (r == 2 and c == 3) else float("nan")
            mgr._health.observe(c, r, latency_s=lat)
            old.observe(c, r, lat)
        mgr._health.finish_round(r)
        old.finish_round(r)
        mgr.args.round_idx = r + 1
        mgr._arm_round_deadline()
        cfg_r = mgr.resilience
        want.append(adaptive_deadline_s(old.ewma, cfg_r.deadline_multiplier,
                                        cfg_r.deadline_grace_s, cfg_r.deadline_min_s,
                                        cfg_r.round_deadline_s))
    assert armed == want
    assert 30.0 in armed and any(a < 30.0 for a in armed)
    mgr.finish()


# -- secure aggregation --------------------------------------------------------------
def _ring(pkg, kind):
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in pkg.get_flight_recorder().snapshot() if e.get("kind") == kind]


def test_secagg_records_and_doctor_counters_equal_the_reference(tmp_path):
    """A masked federation whose round 0 closes at quorum with silo 3 stalled
    (evicted, recovered through its peers' seeds): the same ``secagg_event``
    records, ``secagg_phase`` markers and ``resilience_event`` evictions in
    both packages, and doctor secagg sections with equal counters. On the
    parent tree the port's counters held a ``phases`` key the reference
    never registers (C5)."""
    import test_torch_cross_silo as cs
    import test_torch_secagg as sa

    cfg = sa._sa_cfg(round_deadline_s=1.0, round_quorum=0.66)
    dirs = {}
    feds = {}
    for side in ("jax", "port"):
        c = copy.deepcopy(cfg)
        c["common_args"]["log_file_dir"] = str(tmp_path / side)
        c["common_args"]["run_id"] = "sa_health"
        dirs[side] = str(tmp_path / side / "run_sa_health")
        feds[side] = c
    ref = cs._jax_fed(feds["jax"])
    port = cs._port_fed(feds["port"], cs._jax_init(ref))
    sa._SecAggStall(ref)
    sa._SecAggStall(port)
    assert cs._run_local(ref)["rounds"] == cs._run_local(port)["rounds"] == 3
    jtel.flush_run()
    ttel.flush_run()
    for kind in ("secagg_event", "resilience_event"):
        got, want = _records(dirs["port"], kind), _records(dirs["jax"], kind)
        if kind == "resilience_event":
            got = [e for e in got if e["event"] == "evicted"]
            want = [e for e in want if e["event"] == "evicted"]
        assert got == want, kind
        assert got, kind
    events = _records(dirs["port"], "secagg_event")
    assert [(e["event"], e["round"], e["evicted"]) for e in events] == [
        ("recovery_started", 0, [3]), ("recovery_closed", 0, [3])]
    assert events[1]["seeds"] == 2
    assert _ring(ttel, "secagg_phase") == _ring(jtel, "secagg_phase")
    phases = [e["phase"] for e in _ring(ttel, "secagg_phase")]
    assert {"collect", "recover", "unmask"} <= set(phases)
    assert all(e["individual_plaintext"] is False and e["masked"] is True
               for e in _ring(ttel, "secagg_phase"))
    jd, td = jdoctor.build_doctor(dirs["jax"]), tdoctor.build_doctor(dirs["port"])
    assert td["secagg"]["counters"] == jd["secagg"]["counters"]
    assert "phases" not in td["secagg"]["counters"]
    assert _no_ts(td["secagg"]["events"]) == _no_ts(jd["secagg"]["events"])
    assert [v for v in td["verdict"] if v.startswith("secagg round")] == [
        v for v in jd["verdict"] if v.startswith("secagg round")]
    assert td["connectivity"]["evicted_clients"] == jd["connectivity"]["evicted_clients"]
    # masked uploads have no norm, by design
    ch = _records(dirs["port"], "client_health")
    assert ch and all(e["update_norm"] is None and e["latency_ms"] is not None for e in ch)


# -- integrity ----------------------------------------------------------------------------
def _integrity_run(pkg, run_dir):
    """A screened attacker (NaN), a norm overflow, a z outlier, the quarantines
    that follow and a rollback past its budget, driven through each package's
    rings."""
    if pkg is ttel:
        from fedml_tpu_torch import integrity

        def tree(v, n=8):
            return {"w": torch.full((n,), float(v))}
    else:
        from fedml_tpu import integrity

        def tree(v, n=8):
            return {"w": np.full((n,), float(v), np.float32)}
    pkg.configure(run_dir)
    screen = integrity.UpdateScreen(norm_mult=5.0, z_threshold=3.0)
    q = integrity.QuarantineList(rounds=2)
    guard = integrity.AcceptanceGuard(loss_mult=3.0, min_history=2, max_rollbacks=1)
    for r in range(3):
        for c in range(5):
            v = 1.0 + 0.01 * c
            if r == 1 and c == 4:
                v = float("nan")
            if r == 2 and c == 3:
                v = 100.0
            reason = screen.admit(c, r, tree(v))
            if reason is not None:
                q.quarantine(c, r, reason)
        for c, reason in screen.close_round(r).items():
            q.quarantine(c, r, reason)
    guard.record_rollback(2, "non-finite global parameters")
    try:
        guard.record_rollback(2, "eval loss spike")
    except integrity.RollbackBudgetExceeded:
        pass
    pkg.flush_run()


def test_integrity_records_and_doctor_section_equal_the_reference(tmp_path):
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    _integrity_run(jtel, jdir)
    _integrity_run(ttel, tdir)
    got, want = _records(tdir, "integrity_event"), _records(jdir, "integrity_event")
    assert got == want
    assert {e["event"] for e in got} == {"upload_screened", "quarantined", "round_rolled_back"}
    assert _ring(ttel, "integrity_event") == _ring(jtel, "integrity_event")
    jd, td = jdoctor.build_doctor(jdir), tdoctor.build_doctor(tdir)
    assert _no_ts(td["integrity"]) == _no_ts(jd["integrity"])
    # and each doctor over the other package's run dir
    assert _no_ts(tdoctor.build_doctor(jdir)["integrity"]) == _no_ts(jd["integrity"])
    assert _no_ts(jdoctor.build_doctor(tdir)["integrity"]) == _no_ts(td["integrity"])


# -- the tree ---------------------------------------------------------------------------------
def test_tree_records_equal_the_reference(tmp_path):
    """A 3-tier tree with a leaf kill window and a killed edge: the same
    tier-tagged ``resilience_event`` records (event, tier, round, clients or
    nodes), equal to the ``tier/<d>/*`` counters they stand beside, and a
    ``client_health`` record per leaf-parent edge per round; the doctors'
    tiers sections are equal."""
    from fedml_tpu import hierarchy as jh
    from fedml_tpu.hierarchy import runner as jrunner
    from fedml_tpu_torch import hierarchy as th
    from fedml_tpu_torch.hierarchy import runner as trunner

    levels = (1, 8, 64)
    chaos = [(2, 5, 0, 2), (2, 9, 1, None), (1, 2, 1, None)]
    kw = dict(codec="int8", seed=4, quorum=0.5, chunk=16, ef=True)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtel.configure(jdir)
    jh.TreeRunner(jh.TreeTopology(levels), template=jrunner.default_template(96),
                  chaos=[jh.KillWindow(*c) for c in chaos], **kw).run(3)
    jtel.flush_run()
    ttel.configure(tdir)
    th.TreeRunner(th.TreeTopology(levels), template=trunner.default_template(96),
                  chaos=[th.KillWindow(*c) for c in chaos], device="cpu", **kw).run(3)
    ttel.flush_run()
    got, want = _records(tdir, "resilience_event"), _records(jdir, "resilience_event")
    assert got == want
    assert all(e["tier"] is not None for e in got)
    assert {e["event"] for e in got} >= {"evicted", "rejoined"}
    reg = ttel.get_registry()
    for ev, sig in (("evicted", "evicted"), ("rejoined", "rejoined")):
        for d in range(3):
            n = sum(len(e.get("clients") or e.get("nodes") or [e.get("node")])
                    for e in got if e["event"] == ev and e["tier"] == d)
            assert n == reg.counter(f"tier/{d}/{sig}").value, (ev, d)
    tch, jch = _records(tdir, "client_health"), _records(jdir, "client_health")
    edges = {(e["round"], e["client"]) for e in tch}
    assert edges == {(e["round"], e["client"]) for e in jch} == {
        (r, c) for r in range(3) for c in range(8)}
    assert all(e["latency_ms"] is not None for e in tch)
    jd, td = jdoctor.build_doctor(jdir), tdoctor.build_doctor(tdir)
    assert _no_ts(td["tiers"]["events"]) == _no_ts(jd["tiers"]["events"])
    for d, sig in jd["tiers"]["metrics"].items():
        for k in ("evicted", "rejoined", "quorum_closes", "quorum_failures"):
            assert td["tiers"]["metrics"][d].get(k) == sig.get(k), (d, k)
    assert [v for v in td["verdict"] if v.startswith("tier ")] == [
        v for v in jd["verdict"] if v.startswith("tier ")]


# -- durability counters ----------------------------------------------------------------
def test_durable_restart_and_eviction_count_each_counter_once(tmp_path):
    """A durable server killed after one upload, restarted (journal replay),
    whose replayed round then closes at quorum on its deadline with two
    silos evicted: every ``resilience/*`` counter counts once, as the
    reference's, and each event is one ``resilience_event`` record."""
    import test_torch_durability as dur

    names = ("restarts", "journal_replays", "journal_salvaged", "deadline_fired",
             "quorum_rounds", "clients_evicted", "aborts", "stale_uploads")
    deltas, events = {}, {}
    for side in ("jax", "port"):
        tmp = tmp_path / side
        extra = {"round_deadline_s": 30.0, "round_quorum": 0.3}
        build, upload = ((dur._jax_server, dur._jax_upload_msg) if side == "jax"
                         else (dur._port_server, dur._upload_msg))
        pkg = jtel if side == "jax" else ttel
        before = {n: pkg.get_registry().counter(f"resilience/{n}").value for n in names}
        _, server = build(dur._cs_cfg(f"rh_dur_{side}", tmp, extra=extra))
        mgr = server.manager
        mgr.is_initialized = True
        mgr._select_round_clients()
        mgr._journal_round_open()
        mgr.handle_message_receive_model_from_client(upload(mgr, 2, 0, "old:2:1"))
        _, server2 = build(dur._cs_cfg(f"rh_dur_{side}", tmp, extra=extra))
        mgr2 = server2.manager
        mgr2.send_message = lambda m: None
        mgr2.is_initialized = True
        mgr2._resume_salvaged_round()
        mgr2._deadline.cancel()
        mgr2._on_round_deadline(0)
        mgr2._deadline.cancel()
        deltas[side] = {n: pkg.get_registry().counter(f"resilience/{n}").value - before[n]
                        for n in names}
        events[side] = [(e["event"], e.get("client"), e.get("round"))
                        for e in _records(str(tmp / f"run_rh_dur_{side}"), "resilience_event")]
        mgr.finish()
        mgr2.finish()
    assert deltas["port"] == deltas["jax"] == {
        "restarts": 1, "journal_replays": 1, "journal_salvaged": 1, "deadline_fired": 1,
        "quorum_rounds": 1, "clients_evicted": 2, "aborts": 0, "stale_uploads": 0}
    assert events["port"] == events["jax"]
    assert [e[0] for e in events["port"]] == ["journal_replayed", "deadline_expired",
                                              "evicted", "evicted"]


# -- the comm manager's and the async server's flight-recorder records --------------
def test_send_retry_and_duplicate_records_equal_the_reference():
    """A send that fails once and is retried, and a message delivered twice:
    the same ``send_retry`` and ``duplicate_dropped`` ring records (``ts``
    aside) in both packages."""
    import test_torch_cross_silo as cs
    from fedml_tpu.core.distributed.message import Message as JMessage
    from fedml_tpu_torch.core.distributed.message import Message as TMessage

    cfg = cs._cfg()
    ref = cs._jax_fed(cfg)
    port = cs._port_fed(cfg, cs._jax_init(ref))
    for fed, msg_cls in ((ref, JMessage), (port, TMessage)):
        mgr = fed.server.manager
        calls = []

        def flaky(message, calls=calls):
            calls.append(message)
            if len(calls) == 1:
                raise ConnectionError("link down")

        mgr.com_manager.send_message = flaky
        mgr._send_with_retry(msg_cls("MSG_TYPE_HEALTH_PROBE", 0, 1))
        assert len(calls) == 2
        dup = msg_cls("MSG_TYPE_HEALTH_PROBE", 1, 0)
        dup.add_params(msg_cls.MSG_ARG_KEY_MSG_ID, "probe-1")
        mgr.receive_message("MSG_TYPE_HEALTH_PROBE", dup)
        mgr.receive_message("MSG_TYPE_HEALTH_PROBE", dup)
    for kind in ("send_retry", "duplicate_dropped"):
        got, want = _ring(ttel, kind), _ring(jtel, kind)
        assert got == want and len(got) == 1, (kind, got, want)


def test_async_server_records_equal_the_reference():
    """FedBuff(K=3) over 3 silos, 9 int8 updates: a ``fedbuff_flush`` ring
    record a flush (version and size; the mean staleness is the threads'
    schedule) and an ``async_update`` record an update, in both packages."""
    import test_torch_async as ta

    over = dict(compression="int8", async_buffer_size=3)
    assert ta._run_async("rh_async", **over)["flushes"] == 3
    assert ta._run_jax_async("rh_async_ref", **over)["flushes"] == 3
    for kind, keys in (("fedbuff_flush", ("round", "flushed")),
                       ("async_update", ("round", "sender", "staleness"))):
        got, want = _ring(ttel, kind), _ring(jtel, kind)
        assert [sorted(r) for r in got] == [sorted(r) for r in want], kind
        assert len(got) == (3 if kind == "fedbuff_flush" else 9), kind
    flushes = [(r["round"], r["flushed"]) for r in _ring(ttel, "fedbuff_flush")]
    assert flushes == [(r["round"], r["flushed"]) for r in _ring(jtel, "fedbuff_flush")]
    assert flushes == [(1, 3), (2, 3), (3, 3)]
