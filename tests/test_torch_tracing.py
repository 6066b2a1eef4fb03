"""The port's causal tracing (``fedml_tpu_torch.telemetry.tracing``) against
the JAX package's, on the CPU (``tests/test_tracing.py`` mirrored).

Everything here is host Python over the same records, so every comparison
is exact equality: the clocks ``align_clocks`` recovers, the critical-path
dicts, the Perfetto document, the span frames and the merged record sets,
the report's ``critical_path`` and the doctor's ``tracepath`` and ``live``
sections, and the ``telemetry trace`` output. The acceptance is the
reference's: a 5-round int8 cross-silo federation over the broker, a port
server and in-process client 1 (slowed a little every round) beside a port
client 2 in its own OS process, slowed in rounds 1 and 3. Its spans cross
over the live plane, every round's critical path covers 95-100% of the
round's wall, and client 2 is on the path exactly in its slowed rounds.
"""
import copy
import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import fedml_tpu_torch
from fedml_tpu import telemetry as jtel
from fedml_tpu.telemetry import tracing as jtr
from fedml_tpu.telemetry.registry import MetricsRegistry as JRegistry
from fedml_tpu_torch import cli as tcli
from fedml_tpu_torch import telemetry as ttel
from fedml_tpu_torch.telemetry import tracing as ttr
from fedml_tpu_torch.telemetry.profiling import catalog as tcat
from fedml_tpu_torch.telemetry.profiling import trace as ttrace
from fedml_tpu_torch.telemetry.registry import MetricsRegistry as TRegistry

REPO = Path(__file__).resolve().parents[1]

SLOW_ROUNDS = (1, 3)     # rounds the subprocess client sleeps through
SLOW_SLEEP_S = 1.0       # the deliberate straggler
BASE_SLEEP_S = 0.3       # client 1's every-round handicap: it holds the path
#                          when client 2 is not slowed


def _reset_port():
    ttel.reset_live_plane()
    ttel.reset_registry()
    ttel.reset_tracer()
    ttel.reset_flight_recorder()
    tcat.reset_catalog()
    ttrace.reset_trace_controller()


@pytest.fixture(autouse=True)
def _fresh_port_telemetry():
    """Each test starts and ends with fresh port telemetry (the JAX
    package's is reset by the conftest)."""
    _reset_port()
    yield
    _reset_port()


# -- clock alignment ---------------------------------------------------------------
CLOCK_CASES = {
    "paired": ({"m1": [{"node": "srv", "ts": 100.0}],
                "m2": [{"node": "cli", "ts": 105.5}]},
               {"m1": [{"node": "cli", "ts": 105.01}],
                "m2": [{"node": "srv", "ts": 100.51}]}),
    "one way and unaligned": ({"m1": [{"node": "srv", "ts": 10.0}]},
                              {"m1": [{"node": "cli", "ts": 12.0}],
                               "m9": [{"node": "ghost", "ts": 50.0}]}),
    "reverse only": ({"m1": [{"node": "cli", "ts": 3.0}]},
                     {"m1": [{"node": "srv", "ts": 3.25}]}),
    "many pairs": ({f"m{i}": [{"node": "srv" if i % 2 else f"c{i % 3}",
                               "ts": 10.0 + 0.1 * i}] for i in range(12)},
                   {f"m{i}": [{"node": f"c{i % 3}" if i % 2 else "srv",
                               "ts": 10.0 + 0.1 * i + 0.003 * (i % 5) + 0.7 * (i % 3)}]
                    for i in range(12)}),
}


@pytest.mark.parametrize("case", sorted(CLOCK_CASES))
def test_clock_alignment_equals_the_reference(case):
    sends, recvs = CLOCK_CASES[case]
    want = jtr.align_clocks(copy.deepcopy(sends), copy.deepcopy(recvs), "srv")
    got = ttr.align_clocks(copy.deepcopy(sends), copy.deepcopy(recvs), "srv")
    assert sorted(got) == sorted(want)
    for node in want:
        assert got[node].to_dict() == want[node].to_dict()
        assert (got[node].offset_s, got[node].uncertainty_s) == (
            want[node].offset_s, want[node].uncertainty_s)
    if case == "paired":
        c = got["cli"]
        assert c.method == "paired" and c.pairs == 2
        assert c.offset_s == pytest.approx(5.0, abs=1e-9)
        assert c.uncertainty_s == pytest.approx(0.01, abs=1e-9)
    if case == "one way and unaligned":
        assert got["cli"].method == "one_way" and got["ghost"].method == "unaligned"
        assert got["ghost"].to_dict()["uncertainty_ms"] is None


# -- the critical-path walk --------------------------------------------------------
def _two_node_round(skew: float):
    """The reference's synthetic round: server sync -> config wire -> client
    dispatch/train -> upload wire -> server dispatch/aggregate, the client's
    clock ``skew`` seconds ahead."""
    lat = 0.005
    srv = [
        {"name": "round/0/sync", "trace_id": "t", "span_id": "a",
         "started": 10.000, "duration_ms": 100.0, "service": "srv"},
        {"name": "comm/send", "point": True, "ts": 10.090, "span_id": "a",
         "service": "srv", "attrs": {"msg_id": "m1", "round": 0}},
        {"name": "comm/recv", "point": True, "ts": 10.290 + lat, "span_id": "a",
         "service": "srv", "attrs": {"msg_id": "m2", "round": 0, "peer": 1}},
        {"name": "comm/dispatch", "trace_id": "t", "span_id": "d", "parent_id": "b",
         "remote_parent": True, "started": 10.296, "duration_ms": 50.0,
         "service": "srv", "attrs": {"msg_id": "m2", "round": 0}},
        {"name": "round/0/aggregate", "trace_id": "t", "span_id": "e",
         "parent_id": "d", "started": 10.300, "duration_ms": 30.0, "service": "srv"},
    ]
    cli = [
        {"name": "comm/recv", "point": True, "ts": 10.090 + lat + skew,
         "service": "cli", "attrs": {"msg_id": "m1", "round": 0}},
        {"name": "comm/dispatch", "trace_id": "t", "span_id": "b", "parent_id": "a",
         "remote_parent": True, "started": 10.096 + skew, "duration_ms": 200.0,
         "service": "cli", "attrs": {"msg_id": "m1", "round": 0}},
        {"name": "round/0/client/1/train", "trace_id": "t", "span_id": "c",
         "parent_id": "b", "started": 10.100 + skew, "duration_ms": 180.0,
         "service": "cli"},
        {"name": "comm/send", "point": True, "ts": 10.290 + skew, "span_id": "b",
         "service": "cli", "attrs": {"msg_id": "m2", "round": 0}},
    ]
    return srv + cli


def _three_node_rounds():
    """Two rounds of a server and two clients, client 2 slow in round 1 and
    sent twice (a chaos copy of its upload), so the straggler what-if, the
    duplicate send and the prefetch filter all walk."""
    recs = []
    for r in range(2):
        t = 100.0 * (r + 1)
        recs += [
            {"name": f"round/{r}/sync", "trace_id": f"t{r}", "span_id": f"s{r}",
             "started": t, "duration_ms": 10.0, "service": "rank0"},
            {"name": f"round/{r}/prefetch", "trace_id": f"t{r}", "span_id": f"p{r}",
             "started": t, "duration_ms": 5000.0, "service": "rank0"},
        ]
        for c in (1, 2):
            train = 0.2 + (1.5 if (c == 2 and r == 1) else 0.0)
            mid = f"d{r}{c}"
            recs += [
                {"name": "comm/send", "point": True, "ts": t + 0.009, "span_id": f"s{r}",
                 "service": "rank0", "attrs": {"msg_id": f"b{r}{c}", "round": r, "peer": c}},
                {"name": "comm/recv", "point": True, "ts": t + 0.012 + 0.4 * c,
                 "service": f"rank{c}", "attrs": {"msg_id": f"b{r}{c}", "round": r}},
                {"name": "comm/dispatch", "trace_id": f"t{r}", "span_id": f"c{r}{c}",
                 "parent_id": f"s{r}", "remote_parent": True, "started": t + 0.013 + 0.4 * c,
                 "duration_ms": 1e3 * train + 2.0, "service": f"rank{c}",
                 "attrs": {"msg_id": f"b{r}{c}", "round": r}},
                {"name": f"round/{r}/client/{c}/train", "trace_id": f"t{r}",
                 "span_id": f"k{r}{c}", "parent_id": f"c{r}{c}",
                 "started": t + 0.014 + 0.4 * c, "duration_ms": 1e3 * train,
                 "service": f"rank{c}"},
            ]
            for copy_ in range(2 if (c == 2 and r == 1) else 1):
                recs.append({"name": "comm/send", "point": True,
                             "ts": t + 0.015 + 0.4 * c + train + 0.001 * copy_,
                             "span_id": f"c{r}{c}", "service": f"rank{c}",
                             "attrs": {"msg_id": mid, "round": r}})
            arrive = t + 0.02 + train
            recs += [
                {"name": "comm/recv", "point": True, "ts": arrive, "service": "rank0",
                 "attrs": {"msg_id": mid, "round": r, "peer": c}},
                {"name": "comm/dispatch", "trace_id": f"t{r}", "span_id": f"u{r}{c}",
                 "parent_id": f"c{r}{c}", "remote_parent": True, "started": arrive,
                 "duration_ms": 1.0, "service": "rank0", "attrs": {"msg_id": mid, "round": r}},
            ]
        last = t + 0.03 + 0.2 + (1.5 if r == 1 else 0.0)
        recs += [
            {"name": f"round/{r}/aggregate", "trace_id": f"t{r}", "span_id": f"a{r}",
             "parent_id": f"u{r}2", "started": last, "duration_ms": 20.0,
             "service": "rank0"},
            {"name": f"round/{r}/eval", "trace_id": f"t{r}", "span_id": f"e{r}",
             "parent_id": f"u{r}2", "started": last + 0.021, "duration_ms": 15.0,
             "service": "rank0"},
        ]
    return recs


TRACES = {f"two nodes, skew {s:g}": (lambda s=s: _two_node_round(s))
          for s in (0.0, 2.0, -7.5, 3600.0)}
TRACES["three nodes, two rounds"] = _three_node_rounds


def _cp_dicts(pkg, records, programs=None):
    trace = pkg.assemble_records(copy.deepcopy(records))
    cps = pkg.compute_critical_paths(trace, programs=programs)
    return trace, cps


@pytest.mark.parametrize("case", sorted(TRACES))
def test_critical_paths_equal_the_reference(case):
    records = TRACES[case]()
    programs = [{"name": "local_sgd", "phase_calls": {"round/<n>/client/<id>/train": 3}},
                {"name": "fused_sum", "phase_calls": {"round/<n>/aggregate": 2}}]
    jtrace, jcps = _cp_dicts(jtr, records, programs)
    ttrace_, tcps = _cp_dicts(ttr, records, programs)
    assert ttrace_.ref_node == jtrace.ref_node and ttrace_.nodes == jtrace.nodes
    assert [cp.to_dict() for cp in tcps] == [cp.to_dict() for cp in jcps]
    assert ttr.summarize_critical_paths(tcps) == jtr.summarize_critical_paths(jcps)
    assert {n: c.to_dict() for n, c in ttrace_.clocks.items()} == {
        n: c.to_dict() for n, c in jtrace.clocks.items()}
    for cp in tcps:
        d = cp.to_dict()
        assert sum(s.duration_ms for s in cp.segments) == pytest.approx(d["path_ms"],
                                                                          abs=1e-3)
        assert 0.95 <= d["coverage"] <= 1.0 + 1e-6
    if case.startswith("two nodes"):
        d = tcps[0].to_dict()
        assert d["path_ms"] == pytest.approx(346.0, abs=1e-3)
        assert d["by_kind"]["wire"] == pytest.approx(12.0, abs=1e-3)
        assert d["clients_on_path"] == ["1"]
    else:
        d1 = tcps[1].to_dict()
        assert d1["clients_on_path"] == ["2"] and d1["straggler"]["client"] == "2"
        assert d1["straggler"]["on_critical_path"] is True
        assert any(s.program == "local_sgd" for s in tcps[1].segments)


@pytest.mark.parametrize("rounds", [None, [1]])
def test_perfetto_doc_equals_the_reference(rounds, tmp_path):
    records = _three_node_rounds()
    jtrace, jcps = _cp_dicts(jtr, records)
    ttrace_, tcps = _cp_dicts(ttr, records)
    want = jtr.export_perfetto(jtrace, critical_paths=jcps, rounds=rounds)
    got = ttr.export_perfetto(ttrace_, critical_paths=tcps, rounds=rounds)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert any(e["ph"] == "s" for e in got["traceEvents"])
    assert any(e.get("cat") == "critical-path" for e in got["traceEvents"])
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    jtr.write_perfetto(jtrace, str(jpath), critical_paths=jcps, rounds=rounds)
    ttr.write_perfetto(ttrace_, str(tpath), critical_paths=tcps, rounds=rounds)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert ttr.export_perfetto(ttr.assemble_records([])) == jtr.export_perfetto(
        jtr.assemble_records([]))


def test_phase_codes_roundtrip_like_the_reference():
    assert ttr.PHASE_CODES == jtr.PHASE_CODES
    for name in list(jtr.PHASE_CODES) + ["nonsense", None]:
        assert ttr.phase_code(name) == jtr.phase_code(name)
        assert ttr.phase_label(ttr.phase_code(name)) == jtr.phase_label(jtr.phase_code(name))
    assert ttr.phase_label(ttr.phase_code("train")) == "train"
    for name in ("round/3/client/2/train", "comm/dispatch", "other/x"):
        assert ttr.phase_of(name) == jtr.phase_of(name)


# -- span frames under chaos ------------------------------------------------------
def _frames(pkg, records, registry, resync_every=3):
    streamer = pkg.SpanStreamer("cli", job="chaos", interval_s=0.0,
                                resync_every=resync_every, registry=registry)
    frames = []
    for rec in records:
        streamer.on_record(rec)
        f = streamer.pop_frame(force=True)
        if f is not None:
            frames.append(f)
    final = streamer.close()
    if final is not None:
        frames.append(final)
    return frames


def _counts(registry):
    return {rec["name"]: rec.get("value") for rec in registry.snapshot()}


@pytest.mark.parametrize("ring", [4096, 4])
def test_span_frames_and_merge_equal_the_reference(ring):
    """The port's frames are the reference's field for field; under drops,
    duplicates and reordering both collectors converge to the same records
    and the same critical path; each package's collector takes the other's
    frames; a ring too small to hold the stream counts its losses alike."""
    records = _two_node_round(skew=2.0)
    cli = [r for r in records if r["service"] == "cli"]
    srv = [r for r in records if r["service"] == "srv"]
    jreg, treg = JRegistry(), TRegistry()
    if ring == 4096:
        jframes, tframes = _frames(jtr, cli, jreg), _frames(ttr, cli, treg)
    else:
        out = []
        for pkg, reg in ((jtr, jreg), (ttr, treg)):
            s = pkg.SpanStreamer("cli", job="chaos", interval_s=0.0, ring=ring,
                                 registry=reg)
            for rec in cli * 3:
                s.on_record(dict(rec))
            out.append([f for f in (s.pop_frame(force=True), s.close()) if f])
        jframes, tframes = out
    assert tframes == jframes
    assert _counts(treg) == _counts(jreg)

    def chaos(frames):
        delivered = [f for i, f in enumerate(frames[:-1]) if i % 3 != 0]
        delivered.reverse()
        delivered += [copy.deepcopy(f) for f in delivered[::2]]
        return delivered + [frames[-1]]

    merged = {}
    for pkg, reg_cls in (("jax", JRegistry), ("port", TRegistry)):
        mod = jtr if pkg == "jax" else ttr
        for src in ("jax", "port"):
            reg = reg_cls()
            col = mod.TraceCollector(job="chaos", registry=reg)
            for f in chaos(jframes if src == "jax" else tframes):
                col.ingest(copy.deepcopy(f))
            merged[(pkg, src)] = (col.records(), col.stats(), _counts(reg))
    assert len({json.dumps(v, sort_keys=True) for v in merged.values()}) == 1
    recs = merged[("port", "port")][0]
    if ring == 4096:
        assert merged[("port", "port")][1]["cli"]["records"] == len(cli)
        cp_chaos = ttr.compute_critical_path(ttr.assemble_records(srv + recs), 0)
        clean = ttr.TraceCollector(job="chaos", registry=TRegistry())
        for f in tframes:
            clean.ingest(copy.deepcopy(f))
        cp_clean = ttr.compute_critical_path(
            ttr.assemble_records(srv + clean.records()), 0)
        assert [s.to_dict() for s in cp_chaos.segments] == [
            s.to_dict() for s in cp_clean.segments]
        assert merged[("port", "port")][2]["tracepath/seq_gaps"] > 0


def test_collector_job_gate_and_bad_frames():
    col = ttr.TraceCollector(job="right", registry=TRegistry())
    jcol = jtr.TraceCollector(job="right", registry=JRegistry())
    for frame in ({"kind": "trace", "v": 1, "node": "n", "job": "wrong", "seq": 0,
                   "base": 0, "full": True, "records": [{"name": "x"}]},
                  None, {"kind": "metrics"},
                  {"kind": "trace", "v": 2, "node": "n", "records": []},
                  {"kind": "trace", "v": 1, "node": "n", "seq": "x", "records": []}):
        assert col.ingest(frame) is jcol.ingest(frame) is False
    assert col.records() == [] and col.persist("/nonexistent-run-dir") is None


def test_report_and_doctor_read_a_synthetic_run_dir_like_the_reference(tmp_path):
    """A run dir whose remote client's spans arrived as ``spans_remote.jsonl``:
    both packages' reports give the same ``critical_path`` (clocks included),
    both doctors the same ``tracepath``; the RunData reads each sink once."""
    recs = [{**r, "ended": r["started"] + r["duration_ms"] / 1e3} if "duration_ms" in r
            else r for r in _three_node_rounds()]
    local = [r for r in recs if r["service"] == "rank0"]
    remote = [{**r, "node": r.pop("service")} for r in
              (dict(r) for r in recs if r["service"] != "rank0")]
    run_dir = tmp_path / "run_synth"
    run_dir.mkdir()
    (run_dir / "spans.jsonl").write_text("".join(json.dumps(r) + "\n" for r in local))
    (run_dir / "spans_remote.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in remote))
    treport = ttel.build_report(str(run_dir))
    jreport = jtel.build_report(str(run_dir))
    assert treport["critical_path"] == jreport["critical_path"]
    assert [c["node"] for c in treport["critical_path"]["clocks"]] == [
        "rank0", "rank1", "rank2"]
    assert len(treport["critical_path"]["rounds"]) == 2
    tdoc, jdoc = ttel.build_doctor(str(run_dir)), jtel.build_doctor(str(run_dir))
    assert tdoc["tracepath"] == jdoc["tracepath"]
    assert tdoc["live"] == jdoc["live"]


# -- the acceptance: a 2-process cross-silo federation over the broker ------------------
CLIENT2_CODE = textwrap.dedent(r"""
    import json, sys, time
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.distributed.message import Message
    from fedml_tpu_torch.cross_silo.client.client import Client
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.model_hub import create

    cfg, slow_rounds, slow_s = json.loads(sys.argv[1]), set(json.loads(sys.argv[2])), \
        float(sys.argv[3])
    args = fedml_tpu_torch.init(load_arguments_from_dict(cfg))
    args.rank, args.role = 2, "client"
    ds = load_federated(args)
    model = create(args, ds.class_num)

    class SlowTrainer(ClassificationTrainer):
        def train(self, params, train_data, device, a):
            out = super().train(params, train_data, device, a)
            if self._round_seed in slow_rounds:
                time.sleep(slow_s)
            return out

    client = Client(args, "cpu", ds, model, client_trainer=SlowTrainer(model, args))
    thread = client.manager.run_async()
    client.manager.send_message(Message(MyMessage.MSG_TYPE_CONNECTION_IS_READY, 2, 2))
    thread.join(timeout=300)
    sys.exit(0 if not thread.is_alive() else 3)
""")


def _acceptance_cfg(tmp_path, host, port, log_dir):
    return {
        "common_args": {"training_type": "cross_silo", "random_seed": 9,
                        "run_id": "trace_acc", "log_file_dir": str(log_dir)},
        "data_args": {"dataset": "synthetic", "train_size": 160, "test_size": 60,
                      "class_num": 4, "feature_dim": 12},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "comm_backend": "BROKER",
                       "broker_host": host, "broker_port": port,
                       "object_store_dir": str(tmp_path / "store"),
                       "client_num_in_total": 2, "client_num_per_round": 2,
                       "comm_round": 5, "epochs": 1, "batch_size": 32,
                       "learning_rate": 0.3, "compression": "int8",
                       "live_telemetry": True, "metrics_port": 0,
                       "trace_streaming": True},
    }


def _run_two_process_federation(tmp_path):
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker
    from fedml_tpu_torch.core.distributed.message import Message
    from fedml_tpu_torch.cross_silo.client.client import Client
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.server.server import Server
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.ml.trainer.classification_trainer import ClassificationTrainer
    from fedml_tpu_torch.models.model_hub import create

    broker = PubSubBroker().start()
    host, port = broker.address
    server_logs = tmp_path / "server_logs"
    cfg = _acceptance_cfg(tmp_path, host, port, server_logs)
    sub_cfg = copy.deepcopy(cfg)
    sub_cfg["common_args"]["log_file_dir"] = str(tmp_path / "client2_logs")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-c", CLIENT2_CODE, json.dumps(sub_cfg),
         json.dumps(list(SLOW_ROUNDS)), str(SLOW_SLEEP_S)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        args = fedml_tpu_torch.init(load_arguments_from_dict(cfg))
        args.rank, args.role = 0, "server"
        ds = load_federated(args)
        model = create(args, ds.class_num)
        server = Server(args, "cpu", ds, model)

        class HandicappedTrainer(ClassificationTrainer):
            def train(self, params, train_data, device, a):
                out = super().train(params, train_data, device, a)
                time.sleep(BASE_SLEEP_S)
                return out

        cargs = copy.copy(args)
        cargs.rank, cargs.role = 1, "client"
        client1 = Client(cargs, "cpu", ds, model,
                         client_trainer=HandicappedTrainer(model, cargs))
        managers = [server.manager, client1.manager]
        threads = [m.run_async() for m in managers]
        for m in managers:
            m.send_message(Message(MyMessage.MSG_TYPE_CONNECTION_IS_READY, m.rank, m.rank))
        deadline = time.time() + 240
        while any(t.is_alive() for t in threads) and time.time() < deadline:
            errs = [m.handler_error for m in managers if m.handler_error is not None]
            assert not errs, errs
            time.sleep(0.05)
        assert not any(t.is_alive() for t in threads), "the federation hung"
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, f"client 2's process failed:\n{out[-3000:]}"
        assert server.manager.result is not None and server.manager.result["rounds"] == 5
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        broker.stop()
    ttel.flush_run()
    ttel.reset_live_plane()
    return os.path.join(str(server_logs), "run_trace_acc")


@pytest.fixture(scope="module")
def acceptance_run(tmp_path_factory):
    _reset_port()
    try:
        return _run_two_process_federation(tmp_path_factory.mktemp("trace_acc"))
    finally:
        _reset_port()


def test_acceptance_remote_spans_shipped_and_clock_aligned(acceptance_run):
    assert os.path.exists(os.path.join(acceptance_run, "spans_remote.jsonl"))
    trace = ttr.assemble_trace(acceptance_run)
    assert "rank2" in trace.nodes, trace.nodes
    assert any(s.node == "rank2" and s.client == "2" for s in trace.spans)
    clock = trace.clocks["rank2"]
    assert clock.method in ("paired", "one_way"), clock.to_dict()
    assert clock.uncertainty_s is not None
    jtrace = jtr.assemble_trace(acceptance_run)
    assert {n: c.to_dict() for n, c in trace.clocks.items()} == {
        n: c.to_dict() for n, c in jtrace.clocks.items()}


def test_acceptance_critical_path_covers_every_round(acceptance_run):
    cps = ttr.compute_critical_paths(ttr.assemble_trace(acceptance_run))
    assert [cp.round for cp in cps] == [0, 1, 2, 3, 4]
    for cp in cps:
        d = cp.to_dict()
        assert sum(s.duration_ms for s in cp.segments) == pytest.approx(d["path_ms"],
                                                                          abs=2e-3)
        assert 0.95 <= d["coverage"] <= 1.0 + 1e-6, d
        for seg in cp.segments:
            assert seg.node and seg.phase and seg.kind in ("compute", "wire", "queue")
    jcps = jtr.compute_critical_paths(jtr.assemble_trace(acceptance_run))
    assert [cp.to_dict() for cp in cps] == [cp.to_dict() for cp in jcps]


def test_acceptance_slowed_client_on_path_exactly_when_slowed(acceptance_run):
    cps = {cp.round: cp.to_dict()
           for cp in ttr.compute_critical_paths(ttr.assemble_trace(acceptance_run))}
    # round 0 pays each process's first calls: whichever is slower is on the path
    for r in range(1, 5):
        assert ("2" in cps[r]["clients_on_path"]) == (r in SLOW_ROUNDS), (
            r, cps[r]["clients_on_path"])
    for r in SLOW_ROUNDS:
        st = cps[r]["straggler"]
        assert st is not None and st["client"] == "2" and st["on_critical_path"], cps[r]
        assert st["savings_ms"] >= 0.5 * SLOW_SLEEP_S * 1e3, st


def test_acceptance_report_and_doctor_equal_the_reference(acceptance_run):
    treport, jreport = ttel.build_report(acceptance_run), jtel.build_report(acceptance_run)
    assert treport["critical_path"] == jreport["critical_path"]
    assert len(treport["critical_path"]["rounds"]) == 5
    assert any(c["node"] == "rank2" for c in treport["critical_path"]["clocks"])
    tdoc, jdoc = ttel.build_doctor(acceptance_run), jtel.build_doctor(acceptance_run)
    for key in ("tracepath", "live"):
        assert tdoc[key] == jdoc[key], key
    assert tdoc["tracepath"]["rounds_traced"] == 5
    assert set(tdoc["tracepath"]["clients_on_path"].get("2", [])) >= set(SLOW_ROUNDS)
    # the live plane's own counters reached the run dir
    assert tdoc["live"]["counters"].get("frames_ingested", 0) > 0


def _jax_cli(argv):
    from click.testing import CliRunner

    from fedml_tpu.cli import cli

    res = CliRunner().invoke(cli, argv)
    return res.exit_code, res.output


@pytest.mark.parametrize("argv", [[], ["--json"], ["--round", "3", "--json"]])
def test_acceptance_trace_cli_equals_the_reference(argv, acceptance_run, capsys):
    rc = tcli.main(["telemetry", "trace", acceptance_run, *argv])
    out = capsys.readouterr().out
    jrc, jout = _jax_cli(["telemetry", "trace", acceptance_run, *argv])
    assert rc == jrc == 0
    if "--json" in argv:
        got, want = json.loads(out), json.loads(jout)
        assert got == want
        assert got["schema"] == "fedml_tpu.telemetry.trace/v1"
        assert [r["round"] for r in got["rounds"]] == ([3] if "--round" in argv
                                                       else [0, 1, 2, 3, 4])
    else:
        assert out == jout
        assert "causal trace:" in out and "rank2" in out


def test_acceptance_perfetto_cli_equals_the_reference(acceptance_run, tmp_path, capsys):
    tout, jout = tmp_path / "port.json", tmp_path / "jax.json"
    assert tcli.main(["telemetry", "trace", acceptance_run, "--perfetto", str(tout)]) == 0
    capsys.readouterr()
    assert _jax_cli(["telemetry", "trace", acceptance_run, "--perfetto", str(jout)])[0] == 0
    doc = json.loads(tout.read_text())
    assert doc == json.loads(jout.read_text())
    evs = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms" and sum(e["ph"] == "X" for e in evs) >= 30
    assert "node:rank2" in {e["args"]["name"] for e in evs
                            if e["ph"] == "M" and e["name"] == "process_name"}
    assert any(e["ph"] == "M" and e["args"].get("name") == "critical path" for e in evs)


def test_trace_cli_empty_dir_like_the_reference(tmp_path, capsys):
    rc = tcli.main(["telemetry", "trace", str(tmp_path)])
    out = capsys.readouterr().out
    jrc, jout = _jax_cli(["telemetry", "trace", str(tmp_path)])
    assert rc == jrc == 1 and out == jout and "no spans" in out
