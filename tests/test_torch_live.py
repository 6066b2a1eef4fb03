"""The port's live telemetry plane (``fedml_tpu_torch.telemetry.live``)
against the JAX package's, on the CPU (``tests/test_live_telemetry.py``
mirrored).

Exact equality throughout (host Python over the same state): the metric
frames field for field (``ts`` aside), each package's collector merging the
other's frames to the same totals, the merge under drop, duplicate and
reorder, a node restart's counter reset, the online doctor's alerts for
every rule, the ``/metrics`` text and the ``telemetry watch`` rendering.
End to end on the port: the reference's live cross-silo acceptance (LR, 3
clients over LOCAL, 5 rounds, client 1 slowed: the straggler alert at round
2 during the run, the collector's totals equal to the registry's after it,
a replayed final frame refused), a JAX client's frames ingested by a port
server over the broker, ``TreeRunner(live=)``, the ``tree --metrics-port``
and ``telemetry watch`` commands against the JAX click commands, and the
parameters bit-equal with the plane on and off.
"""
import copy
import json
import os
import threading
import time
import urllib.request

import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import telemetry as jtel
from fedml_tpu.telemetry import live as jlive
from fedml_tpu.telemetry.registry import MetricsRegistry as JRegistry
from fedml_tpu_torch import cli as tcli
from fedml_tpu_torch import telemetry as ttel
from fedml_tpu_torch.telemetry import live as tlive
from fedml_tpu_torch.telemetry.profiling import catalog as tcat
from fedml_tpu_torch.telemetry.profiling import trace as ttrace
from fedml_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry

SLOW_CLIENT = 1
SLOW_SLEEP_S = 0.35


def _reset_port():
    ttel.reset_live_plane()
    ttel.reset_registry()
    ttel.reset_tracer()
    ttel.reset_flight_recorder()
    tcat.reset_catalog()
    ttrace.reset_trace_controller()


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    """Each test starts and ends with fresh port telemetry and no live plane
    (the JAX package's are reset by the conftest)."""
    _reset_port()
    yield
    _reset_port()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _http_get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read().decode()


def _mutate(reg, i):
    """The reference's deterministic registry activity."""
    reg.counter("comm/raw_bytes").inc(100 + i)
    reg.counter("comm/messages_sent", labels={"backend": "local"}).inc()
    reg.gauge("health/clients_reporting").set(3 + (i % 2))
    reg.histogram("health/client_round_ms").observe(5.0 * (i + 1))


def _totals(registry, skip_prefixes=("live/",)):
    out = {}
    for rec in registry.snapshot():
        name = rec["name"]
        if name.startswith(skip_prefixes):
            continue
        labels = {k: v for k, v in (rec.get("labels") or {}).items()
                  if k not in ("node", "job")}
        key = (name, tuple(sorted(labels.items())))
        if rec["kind"] == "histogram":
            out[key] = ("hist", rec["count"], round(rec["sum"], 6))
        else:
            out[key] = (rec["kind"], round(rec.get("value", 0.0), 6))
    return out


def _no_ts(obj):
    if isinstance(obj, dict):
        return {k: _no_ts(v) for k, v in obj.items() if k != "ts"}
    if isinstance(obj, list):
        return [_no_ts(v) for v in obj]
    return obj


# -- frames ---------------------------------------------------------------------------
def _stream(pkg, reg_cls, steps, **kw):
    reg = reg_cls()
    s = pkg.MetricStreamer("n1", job="j", registry=reg, interval_s=999.0, **kw)
    frames = []
    for i in steps:
        if i is None:
            frames.append(s.close())
            continue
        _mutate(reg, i)
        if i % 3 == 2:
            reg.counter(f"comm/extra_{i}").inc(i)
        frames.append(s.pop_frame(force=True))
        frames.append(s.pop_frame(force=True))  # nothing changed: None
    return frames


@pytest.mark.parametrize("kw", [{}, {"max_entries": 2}, {"resync_every": 3}])
def test_metric_frames_equal_the_reference(kw):
    steps = list(range(8)) + [None]
    want = _stream(jlive, JRegistry, steps, **kw)
    got = _stream(tlive, TRegistry, steps, **kw)
    assert _no_ts(got) == _no_ts(want)
    assert got[-1]["full"] is True
    if not kw:
        assert got[1] is None  # nothing changed: no frame, no seq
    assert tlive.FRAME_VERSION == jlive.FRAME_VERSION
    assert tlive.frame_nbytes(_no_ts(got[0])) == jlive.frame_nbytes(_no_ts(want[0]))
    # the plane's own live/* instruments never ride a frame
    assert all(not e["name"].startswith("live/") for f in got if f for e in f["metrics"])


def _frames_of(pkg, reg_cls, n=24, resync_every=4):
    reg = reg_cls()
    src = pkg.MetricStreamer("n1", job="chaos", registry=reg, interval_s=999.0,
                             resync_every=resync_every)
    frames = []
    for i in range(n):
        _mutate(reg, i)
        f = src.pop_frame(force=True)
        if f is not None:
            frames.append(f)
    return reg, frames, src.close()


def test_each_collector_merges_the_others_frames():
    """A JAX frame stream into the port's collector and a port frame stream
    into the JAX package's give the same merged registry as each package's
    own, equal to the source's totals."""
    jreg, jframes, jfinal = _frames_of(jlive, JRegistry)
    treg, tframes, tfinal = _frames_of(tlive, TRegistry)
    assert _totals(jreg) == _totals(treg)
    snaps = {}
    for col_pkg in (jlive, tlive):
        for src, frames, final in (("jax", jframes, jfinal), ("port", tframes, tfinal)):
            col = col_pkg.LiveCollector(job="chaos")
            for f in frames + [final]:
                assert col.ingest(copy.deepcopy(f)) is True
            snaps[(col_pkg.__name__, src)] = (_no_ts(col.snapshot()), _totals(col.registry))
    first = snaps[("fedml_tpu.telemetry.live", "jax")]
    assert all(v == first for v in snaps.values())
    assert first[1] == _totals(treg)


def test_merge_exact_under_duplicate_drop_reorder_like_the_reference():
    """The reference's seeded chaos schedule over the frame stream: the port's
    collector ends exactly at the source's totals, accounts the same gaps
    and duplicates as the JAX package's collector, and refuses the replayed
    final frame."""
    from fedml_tpu.resilience.policy import _unit_hash

    out = {}
    for pkg, reg_cls, tel in ((jlive, JRegistry, jtel), (tlive, TRegistry, ttel)):
        reg, frames, final = _frames_of(pkg, reg_cls)
        col = pkg.LiveCollector(job="chaos")
        dropped, delivered = 0, []
        for f in frames:
            roll = _unit_hash(7, "frame", f["seq"])
            if roll < 0.25:
                dropped += 1
                continue
            if roll < 0.5:
                delivered += [f, copy.deepcopy(f)]
            elif roll < 0.75 and delivered:
                delivered.insert(len(delivered) - 1, f)
            else:
                delivered.append(f)
        assert dropped > 0
        applied = [col.ingest(f) for f in delivered]
        assert col.ingest(final) is True
        assert col.ingest(copy.deepcopy(final)) is False
        assert _totals(col.registry) == _totals(reg)
        plane = {r["name"]: r.get("value") for r in tel.get_registry().snapshot()
                 if r["name"].startswith("live/")}
        assert plane["live/seq_gaps"] >= dropped
        out[pkg.__name__] = (applied, plane, col.nodes()["n1"]["seq"], col.stats()["frames"])
    assert out["fedml_tpu_torch.telemetry.live"] == out["fedml_tpu.telemetry.live"]


def test_counter_reset_on_node_restart_like_the_reference():
    vals = {}
    for pkg, reg_cls, tel in ((jlive, JRegistry, jtel), (tlive, TRegistry, ttel)):
        reg = reg_cls()
        s = pkg.MetricStreamer("n1", registry=reg, interval_s=999.0)
        col = pkg.LiveCollector()
        reg.counter("comm/raw_bytes").inc(100)
        reg.histogram("health/client_round_ms").observe(7.0)
        col.ingest(s.pop_frame(force=True))
        reg2 = reg_cls()  # the node restarts: a fresh registry and streamer
        reg2.counter("comm/raw_bytes").inc(30)
        reg2.histogram("health/client_round_ms").observe(1.0)
        f = pkg.MetricStreamer("n1", registry=reg2, interval_s=999.0).pop_frame(force=True)
        f["seq"] = 99
        col.ingest(f)
        resets = next(r["value"] for r in tel.get_registry().snapshot()
                      if r["name"] == "live/counter_resets")
        vals[pkg.__name__] = (col.value("comm/raw_bytes", node="n1"), resets,
                              _no_ts(col.snapshot()))
    got, want = vals["fedml_tpu_torch.telemetry.live"], vals["fedml_tpu.telemetry.live"]
    assert got == want and got[0] == 130.0 and got[1] == 2


def test_bad_frames_and_the_job_gate_like_the_reference():
    for frame in (None, {"node": "a"}, {"node": "a", "seq": "x", "metrics": []},
                  {"node": "a", "seq": 1, "job": "other", "metrics": []},
                  {"node": "a", "seq": 1, "job": "j",
                   "metrics": [{"name": "x", "kind": "bogus", "value": 1}]}):
        t = tlive.LiveCollector(job="j").ingest(copy.deepcopy(frame))
        j = jlive.LiveCollector(job="j").ingest(copy.deepcopy(frame))
        assert t is j
    bad = {r["name"]: r["value"] for r in ttel.get_registry().snapshot()
           if r["name"] == "live/bad_frames"}
    jbad = {r["name"]: r["value"] for r in jtel.get_registry().snapshot()
            if r["name"] == "live/bad_frames"}
    assert bad == jbad and bad["live/bad_frames"] == 5


# -- the online doctor --------------------------------------------------------------
def _frame(node, seq, metrics, job="j"):
    return {"v": 1, "node": node, "job": job, "seq": seq, "ts": 1.0, "full": False,
            "metrics": metrics}


def _gauge(name, value, **labels):
    e = {"name": name, "kind": "gauge", "value": float(value)}
    if labels:
        e["labels"] = {k: str(v) for k, v in labels.items()}
    return e


def _counter(name, value, **labels):
    e = {"name": name, "kind": "counter", "value": float(value)}
    if labels:
        e["labels"] = {k: str(v) for k, v in labels.items()}
    return e


def _doctor_script(rule):
    """A seeded frame sequence that trips ``rule`` (and what happens around
    it), as (clock seconds, frame) pairs."""
    f = []
    if rule == "straggler":
        for seq, (rounds, score) in enumerate([(1, 3.5), (3, 3.6), (4, 3.7)], 1):
            f.append(_frame("rank0", seq, [_counter("health/rounds_scored", rounds),
                                           _gauge("health/straggler_score", score, client=1),
                                           _gauge("health/straggler_score", 1.0, client=2)]))
    elif rule == "anomaly":
        for seq, rounds in enumerate((2, 3, 4), 1):
            f.append(_frame("rank0", seq, [_counter("health/rounds_scored", rounds),
                                           _gauge("health/anomaly_score", 6.5, client=3)]))
    elif rule == "memory":
        for i, (rnd, mb) in enumerate([(1, 100e6), (2, 160e6), (3, 230e6), (4, 240e6)]):
            f.append(_frame("rank0", 1 + i, [
                _counter("health/rounds_scored", rnd + 1),
                _gauge("mem/device_bytes_in_use", mb, phase="aggregate"),
                _gauge("mem/live_buffer_bytes", 5e6, phase="train")]))
    elif rule == "serving":
        f.append(_frame("rank0", 1, [_gauge("serving/round_published", 5)]))
        f.append(_frame("serve", 1, [_gauge("serving/round_current", 3, endpoint="default")]))
        f.append(_frame("serve", 2, [_gauge("serving/round_current", 5, endpoint="default")]))
        f.append(_frame("rank0", 2, [_gauge("serving/round_published", 8)]))
    elif rule == "slo_burn":
        for seq, (total, bad) in enumerate([(100, 0), (200, 50), (300, 150), (400, 151)], 1):
            f.append(_frame("serve", seq, [
                _counter("serving/slo_total", total, endpoint="e", objective="ttft"),
                _counter("serving/slo_breaches", bad, endpoint="e", objective="ttft"),
                _gauge("serving/slo_objective", 0.99, endpoint="e")]))
    elif rule == "quorum":
        for seq, v in enumerate((1, 1, 2), 1):
            f.append(_frame("rank0", seq, [_counter("resilience/quorum_rounds", v)]))
        f.append(_frame("tree_root", 1, [_counter("tier/1/quorum_failures", 1)]))
    elif rule == "never_rejoined":
        f.append(_frame("rank0", 1, [_counter("health/rounds_scored", 5),
                                     _counter("resilience/clients_evicted", 1)]))
        f.append(_frame("rank0", 2, [_counter("health/rounds_scored", 6)]))
        f.append(_frame("rank0", 3, [_counter("health/rounds_scored", 8)]))
        f.append(_frame("rank0", 4, [_counter("health/rounds_scored", 9),
                                     _counter("resilience/clients_rejoined", 1)]))
    clock = (1000.0, 1100.0, 1400.0, 1500.0) if rule == "slo_burn" else None
    return [(clock[i] if clock else 1000.0 + i, fr) for i, fr in enumerate(f)]


DOCTOR_RULES = ("straggler", "anomaly", "memory", "serving", "slo_burn", "quorum",
                "never_rejoined")


@pytest.mark.parametrize("rule", DOCTOR_RULES)
def test_online_doctor_alerts_equal_the_reference(rule, tmp_path, monkeypatch):
    """The same frame sequence gives the same alerts (fields, order, the
    ``doctor_alert`` records in telemetry.jsonl, the ``live/alerts``
    counters, the flight-recorder markers) in both packages."""
    now = [0.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    out = {}
    for pkg, tel in ((jlive, jtel), (tlive, ttel)):
        run_dir = tmp_path / pkg.__name__
        col = pkg.LiveCollector(job="j")
        doc = pkg.OnlineDoctor(col, run_dir=str(run_dir), rejoin_grace_rounds=2)
        for ts, frame in _doctor_script(rule):
            now[0] = ts
            col.ingest(copy.deepcopy(frame))
        alerts_file = _read_jsonl(run_dir / "telemetry.jsonl") if run_dir.exists() else []
        counters = {tuple(sorted(r["labels"].items())): r["value"]
                    for r in tel.get_registry().snapshot() if r["name"] == "live/alerts"}
        markers = [e for e in tel.get_flight_recorder().snapshot()
                   if e.get("kind") == "doctor_alert"]
        out[pkg.__name__] = (doc.snapshot(), alerts_file, counters, _no_ts(markers))
    got, want = out["fedml_tpu_torch.telemetry.live"], out["fedml_tpu.telemetry.live"]
    assert got == want
    assert got[0], f"{rule}: no alert fired"
    assert got[1] == got[0]
    expected = {"memory": "memory_growth", "serving": "stale_serving_round"}.get(rule, rule)
    assert expected in {a["rule"] for a in got[0]}
    if rule == "straggler":
        assert [(a["client"], a["round"]) for a in got[0]] == [("1", 2)]


def test_straggler_alert_requests_one_capture_like_the_reference():
    """A straggler alert arms one bounded capture of the next round in the
    process's trace controller, deduped per rule."""
    from fedml_tpu.telemetry.profiling import get_trace_controller as jcontroller

    caps = {}
    for pkg, controller in ((jlive, jcontroller), (tlive, ttrace.get_trace_controller)):
        col = pkg.LiveCollector(job="j")
        pkg.OnlineDoctor(col)
        for _, frame in _doctor_script("straggler") * 2:
            col.ingest(copy.deepcopy(frame))
        caps[pkg.__name__] = list(controller()._pending)
    assert caps["fedml_tpu_torch.telemetry.live"] == caps["fedml_tpu.telemetry.live"]
    assert [p["rule"] for p in caps["fedml_tpu_torch.telemetry.live"]] == ["straggler"]


# -- /metrics and watch ----------------------------------------------------------------
def test_scrape_text_and_watch_equal_the_reference():
    """The same collector state serves the same ``/metrics`` text,
    ``/metrics.json`` nodes and alerts, and ``watch --once`` renders the same
    view, in both packages; POST /ingest applies a frame."""
    frames = [_frame("rank1", 1, [_counter("comm/raw_bytes", 512),
                                  _counter("health/rounds_scored", 3),
                                  _gauge("health/straggler_score", 4.0, client=2),
                                  _gauge("mem/device_bytes_in_use", 2e9, phase="train"),
                                  _gauge("tracepath/critical_phase", 1),
                                  _gauge("tracepath/critical_share", 0.75)]),
              _frame("rank0", 1, [_counter("comm/wire_bytes_out", 4096)])]
    hist = {"name": "health/client_round_ms", "kind": "histogram", "count": 2,
            "sum": 12.0, "min": 5.0, "max": 7.0,
            "buckets": {"1": 0, "5": 1, "10": 1, "+inf": 0}}
    frames[1]["metrics"].append(hist)
    texts = {}
    for pkg in (jlive, tlive):
        col = pkg.LiveCollector(job="j")
        doc = pkg.OnlineDoctor(col)
        for f in frames:
            col.ingest(copy.deepcopy(f))
        srv = pkg.MetricsScrapeServer(col, port=0, doctor=doc).start()
        try:
            prom = _http_get(srv.url + "/metrics")
            state = json.loads(_http_get(srv.url + "/metrics.json"))
            health = json.loads(_http_get(srv.url + "/healthz"))
            req = urllib.request.Request(
                srv.url + "/ingest", method="POST",
                data=json.dumps(_frame("rank1", 2, [_counter("comm/raw_bytes", 600)])).encode())
            applied = json.loads(urllib.request.urlopen(req, timeout=5).read())
            shown = []  # what `telemetry watch URL --once` prints
            assert pkg.watch(srv.url, once=True, out=shown.append) == 0
        finally:
            srv.stop()
        rendered = "\n".join(shown)
        texts[pkg.__name__] = (prom, _no_ts({k: v for k, v in state.items()
                                             if k != "uptime_s"}),
                               {k: v for k, v in health.items() if k != "uptime_s"},
                               applied, rendered)
    got, want = texts["fedml_tpu_torch.telemetry.live"], texts["fedml_tpu.telemetry.live"]
    assert got == want
    prom, state, health, applied, rendered = got
    assert 'comm_raw_bytes{job="j",node="rank1"}' in prom
    assert "# TYPE health_client_round_ms histogram" in prom and "live_frames_ingested" in prom
    assert health["ok"] and health["nodes"] == 2 and applied == {"applied": True}
    assert [a["rule"] for a in state["alerts"]] == ["straggler"]
    assert "rank1" in rendered and "train 75%" in rendered


# -- the live cross-silo acceptance ----------------------------------------------------
def _cs_cfg(tmp_path, run_id, rounds=5, live=True, **train):
    return {
        "common_args": {"training_type": "cross_silo", "random_seed": 0,
                        "run_id": run_id, "log_file_dir": str(tmp_path)},
        "data_args": {"dataset": "synthetic", "train_size": 300, "test_size": 60,
                      "class_num": 4, "feature_dim": 12},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": rounds, "epochs": 1,
                       "batch_size": 32, "learning_rate": 0.3,
                       **({"live_telemetry": True, "metrics_port": 0} if live else {}),
                       **train},
    }


def _port_federation(cfg, slow=None):
    """The port's server and 3 clients over LOCAL (not started): client
    ``slow`` sleeps SLOW_SLEEP_S before each training."""
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.client.client import Client
    from fedml_tpu_torch.cross_silo.server.server import Server
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.model_hub import create

    class SlowTrainer(ClassificationTrainer):
        def train(self, params, train_data, device, a):
            time.sleep(SLOW_SLEEP_S)
            return super().train(params, train_data, device, a)

    args = fedml_tpu_torch.init(load_arguments_from_dict(cfg))
    ds = load_federated(args)
    model = create(args, ds.class_num)
    LocalBroker.destroy(str(args.run_id))
    server = Server(args, "cpu", ds, model)
    clients = []
    for rank in (1, 2, 3):
        cargs = copy.copy(args)
        cargs.rank = rank
        trainer = SlowTrainer(model, cargs) if rank == slow else None
        clients.append(Client(cargs, "cpu", ds, model, trainer))
    return args, server, [server.manager] + [c.manager for c in clients]


@pytest.fixture(scope="module")
def live_run(tmp_path_factory):
    """The reference's live acceptance on the port; its observations."""
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion

    _reset_port()
    tmp_path = tmp_path_factory.mktemp("live_accept")
    args, server, managers = _port_federation(_cs_cfg(tmp_path, "live_accept"),
                                              slow=SLOW_CLIENT)
    plane = tlive.current_live_plane()
    assert plane is not None and plane.url is not None
    result, errors = {}, []

    def run():
        try:
            result["r"] = run_managers_to_completion(
                managers, "live_accept", MyMessage.MSG_TYPE_CONNECTION_IS_READY, timeout=240)
        except BaseException as e:  # noqa: BLE001 - surfaced below
            errors.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    scraped, alert_at = None, None
    deadline = time.time() + 200
    while t.is_alive() and time.time() < deadline:
        if scraped is None:
            try:
                prom = _http_get(plane.url + "/metrics", timeout=2)
                if 'node="rank0"' in prom and "health_rounds_scored" in prom:
                    scraped = prom
            except OSError:
                pass
        if alert_at is None and any(a["rule"] == "straggler" for a in plane.doctor.alerts):
            alert_at = time.time()
        if scraped is not None and alert_at is not None:
            break
        time.sleep(0.02)
    t.join(timeout=240)
    ended = time.time()
    run_dir = os.path.join(str(tmp_path), "run_live_accept")
    ttel.flush_run()
    out = dict(plane=plane, result=result.get("r"), errors=errors, alive=t.is_alive(),
               scraped=scraped, alert_at=alert_at, ended=ended, run_dir=run_dir,
               collector=_totals(plane.collector.registry),
               registry=_totals(ttel.get_registry()),
               params={k: v.clone() for k, v in
                       server.fedml_aggregator.get_global_model_params().items()})
    yield out
    _reset_port()


def test_live_cross_silo_straggler_acceptance(live_run):
    assert not live_run["errors"] and not live_run["alive"], live_run["errors"]
    assert live_run["result"]["rounds"] == 5
    # (1) a scrape mid-run saw node- and job-labeled metrics
    assert live_run["scraped"] is not None, "never scraped mid-run"
    assert 'job="live_accept"' in live_run["scraped"]
    # (2) the online doctor fired during the run, at round 2 (3 rounds of evidence)
    assert live_run["alert_at"] is not None and live_run["alert_at"] < live_run["ended"]
    plane = live_run["plane"]
    alert = next(a for a in plane.doctor.alerts if a["rule"] == "straggler")
    assert alert["client"] == str(SLOW_CLIENT) and alert["round"] == 2
    on_disk = [r for r in _read_jsonl(os.path.join(live_run["run_dir"], "telemetry.jsonl"))
               if r.get("kind") == "doctor_alert"]
    assert any(a["rule"] == "straggler" and a["round"] == 2 for a in on_disk)
    # (3) exact: the collector's totals are the post-hoc registry's
    assert live_run["collector"] == live_run["registry"]
    # ... and a replayed final frame is refused and changes nothing
    final_seq = plane.collector.nodes()["rank0"]["seq"]
    replay = {"v": 1, "node": "rank0", "job": "live_accept", "seq": final_seq,
              "ts": time.time(), "full": True, "metrics": []}
    assert plane.collector.ingest(replay) is False
    assert _totals(plane.collector.registry) == live_run["collector"]


def test_live_run_dir_reads_like_the_reference(live_run, capsys):
    """Both doctors give the same ``live`` section (its MID-RUN verdict) and
    the same ``tracepath`` over the live run's dir; ``telemetry watch --once``
    on it prints what the JAX click command prints."""
    run_dir = live_run["run_dir"]
    tdoc, jdoc = ttel.build_doctor(run_dir), jtel.build_doctor(run_dir)
    for key in ("live", "tracepath", "stragglers"):
        assert tdoc[key] == jdoc[key], key
    assert any("MID-RUN" in v for v in tdoc["verdict"])
    assert [v for v in tdoc["verdict"] if "MID-RUN" in v] == [
        v for v in jdoc["verdict"] if "MID-RUN" in v]
    assert any(str(r["client"]) == str(SLOW_CLIENT) for r in tdoc["stragglers"])
    from click.testing import CliRunner

    from fedml_tpu.cli import cli as jcli

    assert tcli.main(["telemetry", "watch", run_dir, "--once"]) == 0
    out = capsys.readouterr().out
    res = CliRunner().invoke(jcli, ["telemetry", "watch", run_dir, "--once"])
    assert res.exit_code == 0 and out == res.output
    assert "offline" in out and "[straggler] round 2" in out
    assert tcli.main(["telemetry", "watch", "http://127.0.0.1:9/x", "--once"]) == 1


def test_parameters_bit_equal_with_the_plane_off(live_run, tmp_path):
    """The same federation without the live plane (and without the slowed
    client's sleep, which moves no number) ends on the same bits."""
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion

    _, server, managers = _port_federation(_cs_cfg(tmp_path, "live_accept", live=False))
    assert tlive.current_live_plane() is None
    res = run_managers_to_completion(managers, "live_accept",
                                     MyMessage.MSG_TYPE_CONNECTION_IS_READY, timeout=240)
    assert res["rounds"] == 5
    off = server.fedml_aggregator.get_global_model_params()
    on = live_run["params"]
    assert sorted(off) == sorted(on)
    assert all(torch.equal(off[k], on[k]) for k in on)


# -- a JAX client's frames into a port server ------------------------------------------
def test_port_server_ingests_a_jax_clients_frames(tmp_path):
    """A mixed federation over the port's broker: a JAX client (its own
    registry and tracer, as its own process would have) piggybacks metric and
    span frames on its uploads, and the port server's plane merges them."""
    from fedml_tpu import models as jhub
    from fedml_tpu.arguments import load_arguments_from_dict as jload
    from fedml_tpu.cross_silo.client.client import Client as JClient
    from fedml_tpu.data import load_federated as jdata
    from fedml_tpu_torch.arguments import load_arguments_from_dict as tload
    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker
    from fedml_tpu_torch.cross_silo.server.server import Server
    from fedml_tpu_torch.data.data_loader import load_federated as tdata
    from fedml_tpu_torch.models.model_hub import create

    broker = PubSubBroker().start()
    try:
        host, port = broker.address
        cfg = _cs_cfg(tmp_path, "mixed_live", rounds=2, comm_backend="BROKER",
                      broker_host=host, broker_port=port,
                      object_store_dir=str(tmp_path / "store"))
        cfg["train_args"].update(client_num_in_total=1, client_num_per_round=1)
        targs = fedml_tpu_torch.init(tload(copy.deepcopy(cfg)))
        tds = tdata(targs)
        server = Server(targs, "cpu", tds, create(targs, tds.class_num))
        jcfg = copy.deepcopy(cfg)
        jcfg["common_args"]["log_file_dir"] = str(tmp_path / "jax_client")
        jargs = fedml_tpu.init(jload(jcfg))
        jargs.rank = 1
        jds = jdata(jargs)
        client = JClient(jargs, None, jds, jhub.create(jargs, jds.class_num))
        plane = tlive.current_live_plane()
        assert plane is not None
        threads = [threading.Thread(target=m.run, daemon=True)
                   for m in (server.manager, client.manager)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads), "the federation hung"
        assert server.manager.result["rounds"] == 2
    finally:
        broker.stop()
    nodes = plane.collector.nodes()
    assert nodes["rank1"]["seq"] >= 1
    # the upload payload bytes: the final frame is taken after the last upload
    # (messages_sent moves once more, with the status that carries the frame)
    jraw = sum(r["value"] for r in jtel.get_registry().snapshot()
               if r["name"] == "comm/raw_bytes")
    got = sum(r["value"] for r in plane.collector.snapshot()
              if r["name"] == "comm/raw_bytes" and r["labels"]["node"] == "rank1")
    assert got == jraw > 0
    remote = _read_jsonl(os.path.join(str(tmp_path), "run_mixed_live", "spans_remote.jsonl"))
    assert any(r.get("node") == "rank1" and r.get("name") == "round/1/client/1/train"
               for r in remote)
    trace = ttel.assemble_trace(os.path.join(str(tmp_path), "run_mixed_live"))
    assert trace.clocks["rank1"].method in ("paired", "one_way")


# -- the tree ---------------------------------------------------------------------------
def test_tree_runner_pumps_the_live_plane_like_the_reference():
    from fedml_tpu import hierarchy as jh
    from fedml_tpu_torch import hierarchy as th

    vals = {}
    for pkg, h, kw in ((jlive, jh, {}), (tlive, th, {"device": "cpu"})):
        plane = pkg.LivePlane(job="tree_j", node="tree_root")
        try:
            out = h.TreeRunner(h.TreeTopology.build(64, tiers=3),
                               template=h.default_template(64), codec="identity", seed=0,
                               live=plane, **kw).run(2)
            assert out["completed"]
            assert plane.collector.nodes()["tree_root"]["seq"] >= 2
        finally:
            plane.close()
        vals[pkg.__name__] = {(r["name"], r["labels"].get("node")): r["value"]
                              for r in plane.collector.snapshot()
                              if r["name"].startswith("tier/")}
    got = vals["fedml_tpu_torch.telemetry.live"]
    assert got == vals["fedml_tpu.telemetry.live"]
    assert got[("tier/2/contributions", "tree_root")] == 128.0


def test_tree_command_with_metrics_port_like_the_reference(capsys):
    from click.testing import CliRunner

    from fedml_tpu.cli import cli as jcli

    argv = ["tree", "--clients", "32", "--tiers", "2", "--rounds", "1", "--params", "32",
            "--codec", "identity", "--metrics-port", "0"]
    assert tcli.main(argv + ["--device", "cpu"]) == 0
    cap = capsys.readouterr()
    got = json.loads(cap.out.strip().splitlines()[-1])
    assert "live telemetry: http://127.0.0.1:" in cap.err
    res = CliRunner().invoke(jcli, argv)
    assert res.exit_code == 0, res.output
    want = json.loads(res.output.strip().splitlines()[-1])
    assert got["completed"] and want["completed"]
    for k in ("levels", "root_total_weight", "per_client_wire_bytes", "f32_tree_nbytes",
              "per_tier", "rounds", "clients", "codec"):
        assert got[k] == want[k], k
    assert tlive.current_live_plane() is None  # the command closed its plane
