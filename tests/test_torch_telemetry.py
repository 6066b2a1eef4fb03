"""The port's span layer (``fedml_tpu_torch.telemetry``) against the JAX
package's (``fedml_tpu.telemetry``), on the CPU.

What must be equal, and how:

* the registry: for the same seeded sequence of operations the snapshot
  lines (every key but the timestamp) and the Prometheus text are equal,
  character for character; the concurrent counter and the histogram's
  percentiles behave as in the reference's own tests;
* spans: the ``telemetry_ctx`` header and the broker envelope are the
  reference's byte for byte (the same context gives the same bytes, and
  each package unwraps the other's); a span published under one package's
  broker client stitches into the other's subscriber, both ways; a publish
  with no open span is byte-unchanged;
* the flight recorder: evicts oldest first within its byte budget; a child
  process sent SIGTERM dumps, names the signal last and dies of it; an
  exception in a thread dumps; an exit dump into a removed run dir neither
  raises nor recreates it;
* the report: over the same run dirs (a 2-round port sp run with a broker
  leg, and a JAX one) the two ``build_report`` agree on rounds, phases,
  counts, comm bytes and stitched spans, and ``telemetry report`` prints
  the same sections;
* tracing changes no number: the sp round's parameters are bit-equal with
  the tracer on and off, and so is an in-process cross-silo aggregate;
* the engines' spans: the cross-silo server's round trace reaches every
  client's spans, in process and across three OS processes sharing one run
  dir; the FedLLM round's profiler events and the FA server's ``mlops``
  records carry the reference's names and keys;
* every span and metric literal of the port passes the reference's
  taxonomy lint.
"""
import copy
import json
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from chip_smoke import untraced as chip_untraced
from fedml_tpu import telemetry as jtel
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch import telemetry as ttel
from fedml_tpu_torch.telemetry import flight_recorder as tfr
from fedml_tpu_torch.telemetry import spans as tspans

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _fresh_telemetry():
    """Each test starts and ends with a fresh port registry, tracer and
    flight recorder (the JAX package's are reset by the conftest)."""
    ttel.reset_registry()
    ttel.reset_tracer()
    ttel.reset_flight_recorder()
    yield
    ttel.reset_registry()
    ttel.reset_tracer()
    ttel.reset_flight_recorder()


@pytest.fixture
def untraced():
    """Calling it makes the next run the untraced twin of a traced one, as
    ``chip_smoke.untraced`` builds it (pair it with ``sys_perf_profiling:
    false``); the fixture undoes it."""
    undo = []
    yield lambda: undo.append(chip_untraced())
    for fn in undo:
        fn()


def _read_jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    env.pop("MASTER_ADDR", None)
    env.pop("MASTER_PORT", None)
    return env


# -- registry ----------------------------------------------------------------
def _registry_ops(seed):
    """A seeded sequence of registry operations, as plain tuples."""
    rng = np.random.default_rng(seed)
    names = ["comm/wire_bytes_out", "broker/bytes_in", "sp/rounds", "serving/ttft_ms",
             "mem/bytes_in_use", "test/a"]
    ops = []
    for _ in range(60):
        name = names[int(rng.integers(len(names)))]
        labels = None if rng.random() < 0.5 else {"backend": str(rng.choice(["grpc", "local"]))}
        kind = ("histogram" if name.endswith("_ms") else
                "gauge" if name.startswith("mem/") else "counter")
        v = float(np.round(rng.random() * 300, 3))
        ops.append((kind, name, labels, v, bool(rng.random() < 0.3)))
    return ops


def _apply(reg, ops, bytes_buckets):
    for kind, name, labels, v, flag in ops:
        if kind == "counter":
            reg.counter(name, labels=labels).inc(v)
        elif kind == "gauge":
            g = reg.gauge(name, labels=labels)
            g.set(v) if flag else g.dec(v / 3)
        else:
            buckets = bytes_buckets if flag else None
            reg.histogram(name + ("_b" if flag else ""), labels=labels,
                          buckets=buckets).observe(v)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_prometheus_equal_the_reference(seed, tmp_path):
    ops = _registry_ops(seed)
    j, t = jtel.MetricsRegistry(), ttel.MetricsRegistry()
    _apply(j, ops, jtel.BYTES_BUCKETS)
    _apply(t, ops, ttel.BYTES_BUCKETS)
    assert t.snapshot() == j.snapshot()
    assert t.export_prometheus() == j.export_prometheus()
    for prefix in ("comm/", "serving/", "none/"):
        assert t.export_prometheus(name_prefix=prefix) == j.export_prometheus(
            name_prefix=prefix)
    jl = [json.loads(x) for x in _read_lines(j.flush_jsonl(str(tmp_path / "j")))]
    tl = [json.loads(x) for x in _read_lines(t.flush_jsonl(str(tmp_path / "t")))]
    assert [list(r) for r in tl] == [list(r) for r in jl]  # key for key, in order
    for a, b in zip(tl, jl):
        a.pop("ts"), b.pop("ts")
        assert a == b


def _read_lines(path):
    with open(path) as f:
        return [line for line in f.read().splitlines() if line]


def test_registry_constants_and_name_rule_equal_the_reference():
    from fedml_tpu.telemetry import registry as jreg
    from fedml_tpu_torch.telemetry import registry as treg

    assert treg.BYTES_BUCKETS == jreg.BYTES_BUCKETS
    assert treg.DEFAULT_BUCKETS_MS == jreg.DEFAULT_BUCKETS_MS
    assert treg._NAME_RE.pattern == jreg._NAME_RE.pattern
    for bad in ("Bad Name", "a//b", "a/", "/a", "a-b"):
        with pytest.raises(ValueError):
            ttel.MetricsRegistry().counter(bad)


def test_counter_concurrent_writers():
    c = ttel.MetricsRegistry().counter("test/hits")
    threads = [threading.Thread(target=lambda: [c.inc() for _ in range(1000)])
               for _ in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert c.value == 8000
    with pytest.raises(ValueError):
        c.inc(-1)


def test_histogram_concurrent_percentiles_and_accessors():
    h = ttel.MetricsRegistry().histogram("test/latency_ms")
    jh = jtel.MetricsRegistry().histogram("test/latency_ms")

    def observe():
        for i in range(500):
            h.observe(i % 100)

    threads = [threading.Thread(target=observe) for _ in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for _ in range(3):
        for i in range(500):
            jh.observe(i % 100)
    snap = h.snapshot()
    assert snap == jh.snapshot()
    assert snap["count"] == h.count == 1500 and h.sum == jh.sum
    assert 25 <= snap["p50"] <= 75
    assert snap["p95"] <= snap["p99"] <= snap["max"] == 99
    for q in (0.0, 0.5, 0.9, 0.999, 1.0):
        assert h.percentile(q) == jh.percentile(q)


def test_histogram_merge_delta_and_gauge_inc_dec_equal_the_reference():
    out = []
    for tel in (jtel, ttel):
        reg = tel.MetricsRegistry()
        h = reg.histogram("live/frame_ms", buckets=(1, 10, 100))
        h.observe(3)
        h.merge_delta([1, 0, 2, 1], 4, 321.5, observed_min=0.5, observed_max=150.0)
        with pytest.raises(ValueError):
            h.merge_delta([1, 2], 3, 1.0)
        g = reg.gauge("mem/x")
        g.inc(5)
        g.dec(1.5)
        out.append((h.snapshot(), g.value))
    assert out[0] == out[1]


def test_set_and_reset_registry():
    mine = ttel.MetricsRegistry()
    ttel.set_registry(mine)
    assert ttel.get_registry() is mine
    ttel.reset_registry()
    assert ttel.get_registry() is not mine


# -- spans -----------------------------------------------------------------------
def test_span_nesting_and_sink(tmp_path):
    tracer = ttel.Tracer(sink_dir=str(tmp_path))
    with tracer.span("round/0/train") as parent:
        with tracer.span("round/0/client/2/train", n_samples=10) as child:
            pass
    assert child.trace_id == parent.trace_id and child.parent_id == parent.span_id
    tracer.flush()
    recs = _read_jsonl(tmp_path / "spans.jsonl")
    assert {r["name"] for r in recs} == {"round/0/train", "round/0/client/2/train"}
    child_rec = next(r for r in recs if "client" in r["name"])
    assert child_rec["attrs"]["n_samples"] == 10 and not child_rec.get("remote_parent")
    # the record's keys are the reference tracer's
    jtracer = jtel.Tracer(sink_dir=str(tmp_path / "j"))
    with jtracer.span("round/0/train"):
        with jtracer.span("round/0/client/2/train", n_samples=10):
            pass
    jtracer.flush()
    jrecs = _read_jsonl(tmp_path / "j" / "spans.jsonl")
    assert [sorted(r) for r in recs] == [sorted(r) for r in jrecs]


def test_context_header_inject_extract_across_packages():
    for make, other in ((ttel, jtel), (jtel, ttel)):
        tracer = make.Tracer()
        params = {}
        with tracer.span("comm/send"):
            make.inject_context(params)
            ctx = make.current_context()
        assert params[make.CTX_KEY] == {"trace_id": ctx.trace_id, "span_id": ctx.span_id}
        assert make.CTX_KEY == other.CTX_KEY == "telemetry_ctx"
        extracted = other.extract_context(params)
        assert other.CTX_KEY not in params
        assert (extracted.trace_id, extracted.span_id) == (ctx.trace_id, ctx.span_id)
        token = other.activate_context(extracted)
        try:
            with other.Tracer().span("round/1/client/3/train") as s:
                assert s.trace_id == ctx.trace_id and s.parent_id == ctx.span_id
                assert s.remote_parent
        finally:
            other.deactivate_context(token)
    assert ttel.extract_context({"telemetry_ctx": "junk"}) is None
    assert ttel.extract_context({}) is None


@pytest.mark.parametrize("body", [b"", b"payload-bytes", bytes(range(256)) * 3])
def test_frame_envelope_bytes_equal_the_reference(body):
    ctx_t = ttel.TraceContext("0123456789abcdef0123456789abcdef", "fedcba9876543210")
    ctx_j = jtel.TraceContext(ctx_t.trace_id, ctx_t.span_id)
    wrapped = ttel.wrap_frame_body(body, ctx_t)
    assert wrapped == jtel.wrap_frame_body(body, ctx_j)
    assert wrapped[:4] == b"\xf5TCX"
    for unwrap, wrap, ctx in ((jtel.unwrap_frame_body, ttel.wrap_frame_body, ctx_t),
                              (ttel.unwrap_frame_body, jtel.wrap_frame_body, ctx_j)):
        got, rest = unwrap(wrap(body, ctx))
        assert (got.trace_id, got.span_id, rest) == (ctx.trace_id, ctx.span_id, body)
    # no context, or a body that merely starts with the magic, passes through
    assert ttel.wrap_frame_body(body) == body
    for raw in (b"\xf5TCX", b"\xf5TCX\x00\x09{bad", b"\xf5TCX\x00\x02{}" + body, body):
        got, ref = ttel.unwrap_frame_body(raw), jtel.unwrap_frame_body(raw)
        assert got[0] is None and ref[0] is None and got[1] == ref[1] == raw


def test_tracer_event_is_a_point_record(tmp_path):
    from fedml_tpu.telemetry.report import _spans_from_raw as j_spans_from_raw
    from fedml_tpu_torch.telemetry.report import _spans_from_raw

    tracer = ttel.Tracer(sink_dir=str(tmp_path), service="t")
    with tracer.span("round/0/sync"):
        rec = tracer.event("comm/send", msg_id="m1", peer=1)
    assert rec["point"] is True and "duration_ms" not in rec
    assert rec["attrs"]["msg_id"] == "m1" and rec["span_id"] and rec["mono"] > 0
    assert _spans_from_raw([rec], []) == j_spans_from_raw([rec], []) == []
    jrec = jtel.Tracer(service="t").event("comm/send", msg_id="m1", peer=1)
    assert sorted(jrec) == sorted(k for k in rec if k not in ("trace_id", "span_id"))


def test_span_listener_receives_spans_and_events(tmp_path):
    tracer = ttel.Tracer(sink_dir=str(tmp_path), service="t")
    got = []
    ttel.add_span_listener(got.append)
    ttel.add_span_listener(lambda rec: 1 / 0)  # a raising listener is ignored
    try:
        with tracer.span("round/0/sync"):
            tracer.event("comm/send", msg_id="m")
    finally:
        ttel.remove_span_listener(got.append)
        tspans._span_listeners.clear()
    assert [r["name"] for r in got] == ["comm/send", "round/0/sync"]
    tracer.event("comm/send", msg_id="m2")
    assert len(got) == 2


def test_span_duration_survives_wall_clock_step(tmp_path, monkeypatch):
    tracer = ttel.Tracer(sink_dir=str(tmp_path), service="t")
    real_time = time.time
    step = [0.0]
    monkeypatch.setattr(tspans.time, "time", lambda: real_time() + step[0])
    span = tracer.begin("round/0/sync")
    step[0] = -3600.0  # the wall clock jumps back an hour mid-span
    time.sleep(0.02)
    rec = tracer.end(span)
    assert 15.0 <= rec["duration_ms"] < 5000.0, rec["duration_ms"]
    assert "mono" in rec
    assert rec["ended"] == pytest.approx(rec["started"] + rec["duration_ms"] / 1e3)


@pytest.mark.parametrize("tel", [ttel, jtel], ids=["port", "jax"])
def test_memory_only_tracer_writes_nothing(tel, tmp_path, monkeypatch):
    """An unconfigured tracer keeps its records in memory, and
    ``flush_run`` lands nothing, in both packages."""
    monkeypatch.chdir(tmp_path)
    tel.reset_tracer()
    tracer = tel.get_tracer()
    with tracer.span("round/0/train"):
        tracer.event("comm/send")
    assert [r["name"] for r in tracer.records()] == ["comm/send", "round/0/train"]
    assert tracer.sink_dir is None and tel.flush_run() is None
    assert tracer.records() == [] and not os.listdir(tmp_path)
    tel.reset_tracer()


def test_configure_from_args_layout_and_service(tmp_path):
    args = targuments.load_arguments_from_dict(
        {"common_args": {"run_id": "r7", "log_file_dir": str(tmp_path)}})
    t = ttel.configure_from_args(args, service="rank3")
    assert t.sink_dir == os.path.join(str(tmp_path), "run_r7") and t.service == "rank3"
    assert ttel.get_tracer() is t and ttel.configure_from_args(args, service="x") is t
    assert tfr.get_flight_recorder().sink_dir == t.sink_dir
    with t.span("round/0/sync"):
        pass
    assert ttel.flush_run() == os.path.join(t.sink_dir, "telemetry.jsonl")
    (rec,) = _read_jsonl(os.path.join(t.sink_dir, "spans.jsonl"))
    assert rec["service"] == "rank3"


def test_kernel_build_time_lands_in_the_open_span(tmp_path):
    tracer = ttel.Tracer(sink_dir=str(tmp_path))
    with tracer.span("round/0/train") as s:
        ttel.note_kernel_build("flash_attention.cu", 1234.5)
    ttel.note_kernel_build("dequant_matmul.cu", 7.0)  # no open span: histogram only
    rec = tracer.records()[0]
    assert s.compile_ms == rec["compile_ms"] == 1234.5
    assert rec["execute_ms"] == max(rec["duration_ms"] - 1234.5, 0.0)
    h = ttel.get_registry().histogram("build/compile_ms")
    assert h.count == 2 and h.sum == 1241.5
    tracer.flush()
    report = ttel.build_report(str(tmp_path))
    assert report["compile_ms"] == 1234.5
    assert "kernel builds vs execute: build 1234.5 ms" in ttel.format_report(report)


def test_build_module_reports_to_the_open_span(monkeypatch, tmp_path):
    """``ops/_build._compile`` times the compiler and hands the time to the
    span layer (a stand-in compiler: ``true``)."""
    from fedml_tpu_torch.ops import _build

    seen = []
    monkeypatch.setattr(tspans, "note_kernel_build", lambda what, ms: seen.append((what, ms)))
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    (tmp_path / "k.cpp").write_text("int main() { return 0; }\n")
    out = tmp_path / "out" / "k"

    def fake_run(cmd, **kw):
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, "", "")

    monkeypatch.setattr(_build.subprocess, "run", fake_run)
    _build._compile("k", ".cpp", "c++", (), out)
    assert out.exists() and len(seen) == 1 and seen[0][0] == "k.cpp" and seen[0][1] >= 0


# -- the broker, both ways ----------------------------------------------------------
def _broker_leg(pub_mod, sub_mod, pub_tel, sub_tel, propagate=True, body=b"payload-bytes"):
    """Publish ``body`` under a span of ``pub_tel`` through ``pub_mod``'s
    client; the subscriber (``sub_mod``'s client) opens a span of
    ``sub_tel`` in its handler. Returns (received body, publisher context,
    subscriber span)."""
    broker = sub_mod.PubSubBroker().start()
    host, port = broker.address
    sub = sub_mod.BrokerClient(host, port)
    done, seen = threading.Event(), {}

    def handler(b):
        with sub_tel.Tracer().span("round/0/client/1/train") as s:
            seen["body"], seen["span"] = b, s
        done.set()

    sub.subscribe("fedml/t", handler)
    _wait_subscribed(broker, "fedml/t")
    pub = pub_mod.BrokerClient(host, port, propagate_trace=propagate)
    try:
        with pub_tel.Tracer().span("round/0/sync") as s:
            ctx = s.context()
            pub.publish("fedml/t", body)
        assert done.wait(10), "the subscriber never got the frame"
    finally:
        pub.close()
        sub.close()
        broker.stop()
    return seen["body"], ctx, seen["span"]


def _wait_subscribed(broker, topic, timeout=10.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        with broker._lock:
            if broker._subs.get(topic):
                return
        time.sleep(0.005)
    raise AssertionError(f"no subscriber on {topic}")


@pytest.mark.parametrize("direction", ["port->port", "jax->port", "port->jax"])
def test_span_stitches_across_the_broker(direction):
    """A span published under an open span stitches into the subscriber's
    span: the envelope is stripped, the trace id carried, the publisher's
    span the parent. ``jax->port`` is the mixed federation's seam (C4)."""
    from fedml_tpu.core.distributed.communication import broker as jbroker
    from fedml_tpu_torch.core.distributed.communication import broker as tbroker

    pub, sub = direction.split("->")
    mods = {"port": (tbroker, ttel), "jax": (jbroker, jtel)}
    body, ctx, span = _broker_leg(mods[pub][0], mods[sub][0], mods[pub][1], mods[sub][1])
    assert body == b"payload-bytes"
    assert span.trace_id == ctx.trace_id and span.parent_id == ctx.span_id
    assert span.remote_parent


@pytest.mark.parametrize("case", ["no span", "propagate off"])
def test_plain_publish_is_byte_unchanged(case):
    from fedml_tpu_torch.core.distributed.communication import broker as tbroker

    broker = tbroker.PubSubBroker().start()
    host, port = broker.address
    sub = tbroker.BrokerClient(host, port, propagate_trace=False)
    got, done = [], threading.Event()
    sub.subscribe("x", lambda b: (got.append(b), done.set()))
    _wait_subscribed(broker, "x")
    pub = tbroker.BrokerClient(host, port, propagate_trace=case != "propagate off")
    raw = b"\xf5" + b"raw" + bytes(range(10))  # a near-magic prefix passes through
    try:
        if case == "no span":
            pub.publish("x", raw)
        else:
            with ttel.Tracer().span("round/0/sync"):
                pub.publish("x", raw)
        assert done.wait(10)
        assert got == [raw]
    finally:
        pub.close()
        sub.close()
        broker.stop()


def test_native_broker_relays_the_envelope_opaquely():
    """The C++ broker (``deploy broker --native``) routes a wrapped body
    untouched: the port's subscriber unwraps it and stitches."""
    from fedml_tpu_torch.core.distributed.communication import broker as tbroker

    try:
        native = tbroker.NativePubSubBroker("127.0.0.1", 0).start()
    except RuntimeError as e:  # no host compiler on this machine
        pytest.fail(f"the C++ broker did not start: {e}")
    try:
        host, port = native.address
        sub = tbroker.BrokerClient(host, port)
        done, seen = threading.Event(), {}

        def handler(b):
            with ttel.Tracer().span("round/0/client/1/train") as s:
                seen["body"], seen["span"] = b, s
            done.set()

        sub.subscribe("fedml/n", handler)
        time.sleep(0.3)
        pub = tbroker.BrokerClient(host, port)
        try:
            with ttel.Tracer().span("round/0/sync") as s:
                pub.publish("fedml/n", b"model-update")
            assert done.wait(10)
        finally:
            pub.close()
            sub.close()
        assert seen["body"] == b"model-update"
        assert seen["span"].trace_id == s.trace_id and seen["span"].parent_id == s.span_id
    finally:
        native.stop()


# -- the flight recorder ----------------------------------------------------------
def test_byte_budget_evicts_oldest_first():
    fr = tfr.FlightRecorder(max_bytes=2000, max_events=1000)
    jfr = jtel.FlightRecorder(max_bytes=2000, max_events=1000)
    for i in range(200):
        for r in (fr, jfr):
            r.record("span", name=f"round/{i}/train", round=i)
    assert fr.nbytes <= 2000 and len(fr) == len(jfr) and fr.dropped == jfr.dropped > 0
    rounds = [r["round"] for r in fr.snapshot()]
    assert rounds == list(range(200 - len(rounds), 200))  # the newest kept, in order
    assert fr.last_round() == 199
    small = tfr.FlightRecorder(max_bytes=1 << 20, max_events=3)
    for i in range(5):
        small.record("e", i=i)
    assert [r["i"] for r in small.snapshot()] == [2, 3, 4]


def test_dump_header_and_on_span(tmp_path):
    fr = tfr.FlightRecorder()
    fr.record("round_start", round=4)
    tfr.on_span({"name": "round/4/train", "duration_ms": 1.23456, "started": 1.0})
    fr2 = tfr.get_flight_recorder()
    assert fr2.snapshot()[-1] == {**fr2.snapshot()[-1], "kind": "span", "name": "round/4/train",
                                  "duration_ms": 1.235}
    path = fr.dump(str(tmp_path), reason="manual", exc=ValueError("boom"))
    head, *rest = _read_jsonl(path)
    assert head["kind"] == "crash_context" and head["reason"] == "manual"
    assert head["last_round"] == 4 and head["exc_type"] == "ValueError"
    assert head["exc_message"] == "boom" and [r["kind"] for r in rest] == ["round_start"]
    assert tfr.FlightRecorder().dump() is None  # unbound: nothing to write


SIGNAL_CHILD = textwrap.dedent(r"""
    import os, signal, sys, time
    from fedml_tpu_torch import telemetry
    from fedml_tpu_torch.telemetry import flight_recorder
    mode, run_dir = sys.argv[1], sys.argv[2]
    if mode == "chained":
        def prev(signum, frame):
            open(os.path.join(run_dir, "prev_handler_ran"), "w").close()
            os._exit(3)
        os.makedirs(run_dir, exist_ok=True)
        signal.signal(signal.SIGTERM, prev)
    if mode == "thread_bind":
        import threading
        th = threading.Thread(target=flight_recorder.bind, args=(run_dir,))
        th.start(); th.join()
        print("HANDLER", signal.getsignal(signal.SIGTERM) is signal.SIG_DFL, flush=True)
    tracer = telemetry.configure(run_dir, service="child")
    with tracer.span("round/0/train"):
        pass
    flight_recorder.record("round_end", round=0)
    print("READY", flush=True)
    time.sleep(60)
""")


def _start_child(mode, run_dir):
    proc = subprocess.Popen([sys.executable, "-c", SIGNAL_CHILD, mode, str(run_dir)],
                            cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = []
    for line in proc.stdout:
        lines.append(line.strip())
        if line.strip() == "READY":
            return proc, lines
    proc.wait()
    raise AssertionError(proc.stderr.read())


@pytest.mark.parametrize("mode", ["default", "chained", "thread_bind"])
def test_sigterm_dumps_and_dies_of_the_signal(mode, tmp_path):
    run_dir = tmp_path / "run"
    proc, lines = _start_child(mode, run_dir)
    try:
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    recs = _read_jsonl(run_dir / "flight_recorder.jsonl")
    head, last = recs[0], recs[-1]
    assert head["kind"] == "crash_context" and head["reason"] == "sigterm"
    assert head["last_round"] == 0 and head["pid"] == proc.pid
    assert last["kind"] == "signal" and last["signal"] == "SIGTERM"
    assert "span" in [r["kind"] for r in recs]
    if mode == "chained":  # the handler that was there before still runs
        assert proc.returncode == 3 and (run_dir / "prev_handler_ran").exists()
    else:
        assert proc.returncode == -signal.SIGTERM
    if mode == "thread_bind":  # no handler from a worker thread
        assert "HANDLER True" in lines


EXC_CHILD = textwrap.dedent(r"""
    import shutil, sys, threading
    from fedml_tpu_torch import telemetry
    mode, run_dir = sys.argv[1], sys.argv[2]
    tracer = telemetry.configure(run_dir)
    with tracer.span("round/0/train"):
        pass
    if mode == "thread":
        def boom():
            raise ValueError("boom in a worker")
        th = threading.Thread(target=boom)
        th.start(); th.join()
    else:
        tracer.flush()  # the run dir exists now
        with tracer.span("round/1/train"):  # buffered for the exit flush
            pass
        shutil.rmtree(run_dir)
""")


def test_exception_in_a_thread_dumps(tmp_path):
    run_dir = tmp_path / "run"
    proc = subprocess.run([sys.executable, "-c", EXC_CHILD, "thread", str(run_dir)],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "boom in a worker" in proc.stderr  # the previous hook still printed it
    head = _read_jsonl(run_dir / "flight_recorder.jsonl")[0]
    assert head["reason"] == "exception" and head["exc_type"] == "ValueError"
    assert "boom in a worker" in head["traceback"]


def test_exit_dump_into_a_removed_dir_does_not_raise(tmp_path):
    run_dir = tmp_path / "run"
    proc = subprocess.run([sys.executable, "-c", EXC_CHILD, "removed", str(run_dir)],
                          cwd=REPO, env=_env(), capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0 and "Traceback" not in proc.stderr, proc.stderr
    assert not run_dir.exists()


APPEND_CHILD = textwrap.dedent(r"""
    import sys
    from fedml_tpu_torch import telemetry
    run_dir, rank = sys.argv[1], sys.argv[2]
    tracer = telemetry.Tracer(sink_dir=run_dir, service=f"rank{rank}", buffer_limit=7)
    for i in range(400):
        with tracer.span(f"round/{i}/client/{rank}/train", pad="x" * (i % 97)):
            pass
    tracer.flush()
""")


def test_three_processes_append_whole_lines(tmp_path):
    procs = [subprocess.Popen([sys.executable, "-c", APPEND_CHILD, str(tmp_path), str(r)],
                              cwd=REPO, env=_env(), stderr=subprocess.PIPE, text=True)
             for r in range(3)]
    for p in procs:
        assert p.wait(timeout=60) == 0, p.stderr.read()
    recs = _read_jsonl(tmp_path / "spans.jsonl")  # every line parses
    assert len(recs) == 1200
    for r in range(3):
        mine = [x for x in recs if x["service"] == f"rank{r}"]
        assert sorted(int(x["name"].split("/")[1]) for x in mine) == list(range(400))


# -- the report ------------------------------------------------------------------
def _sp_cfg(run_id, log_dir, **train):
    cfg = {
        "common_args": {"training_type": "simulation", "random_seed": 0,
                        "run_id": run_id, "log_file_dir": str(log_dir)},
        "data_args": {"dataset": "synthetic", "partition_method": "hetero",
                      "partition_alpha": 0.5, "train_size": 200, "test_size": 80,
                      "class_num": 3, "feature_dim": 10},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": 2, "epochs": 1,
                       "batch_size": 16, "learning_rate": 0.3},
    }
    cfg["train_args"].update(train)
    return cfg


def _port_sp(cfg):
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

    args = fedml_tpu_torch.init(load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = load_federated(args)
    api = FedAvgAPI(args, "cpu", ds, create(args, ds.class_num))
    api.train()
    return api


def _jax_sp(cfg):
    from fedml_tpu import device as device_mod
    from fedml_tpu import models as models_mod
    from fedml_tpu.arguments import load_arguments_from_dict
    from fedml_tpu.data import load_federated
    from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI

    args = fedml_tpu.init(load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = load_federated(args)
    api = FedAvgAPI(args, device_mod.get_device(args), ds, models_mod.create(args, ds.class_num))
    api.train()
    return api


def _acceptance_run_dir(side, tmp_path):
    """The reference's acceptance run dir (``test_telemetry.py``): a 2-round
    sp run, then a broker leg published under a span with the subscriber's
    span stitched, the counters flushed into the same dir."""
    from fedml_tpu.core.distributed.communication import broker as jbroker
    from fedml_tpu_torch.core.distributed.communication import broker as tbroker

    tel, bmod, run = ((ttel, tbroker, _port_sp) if side == "port"
                      else (jtel, jbroker, _jax_sp))
    run(_sp_cfg(f"acc_{side}", tmp_path / side))
    run_dir = os.path.join(str(tmp_path / side), f"run_acc_{side}")
    tracer = tel.get_tracer()
    assert tracer.sink_dir == run_dir
    broker = bmod.PubSubBroker().start()
    host, port = broker.address
    sub = bmod.BrokerClient(host, port)
    done = threading.Event()

    def handler(body):
        with tracer.span("round/1/client/9/train"):
            pass
        done.set()

    sub.subscribe("fedml/acc", handler)
    _wait_subscribed(broker, "fedml/acc")
    pub = bmod.BrokerClient(host, port)
    try:
        with tracer.span("round/1/sync"):
            pub.publish("fedml/acc", b"model-update")
        assert done.wait(10)
    finally:
        pub.close()
        sub.close()
        broker.stop()
    tracer.flush()
    tel.get_registry().flush_jsonl(run_dir)
    return run_dir


def _same_report(run_dir):
    jr, tr = jtel.build_report(run_dir), ttel.build_report(run_dir)
    for key in ("rounds", "phases", "stragglers", "n_spans", "n_metrics", "comm_bytes",
                "stitched_spans", "compression", "services", "stage_overlap"):
        assert tr[key] == jr[key], key
    assert sorted(tr) == sorted(jr)
    return jr, tr


@pytest.mark.parametrize("side", ["port", "jax"])
def test_reports_agree_over_either_packages_run_dir(side, tmp_path):
    run_dir = _acceptance_run_dir(side, tmp_path)
    jr, tr = _same_report(run_dir)
    assert [r["round"] for r in tr["rounds"]] == [0, 1]
    assert all(r["wall_ms"] > 0 for r in tr["rounds"])
    phases = {p["phase"]: p for p in tr["phases"]}
    for phase in ("round/<n>/train", "round/<n>/aggregate", "round/<n>/client/<id>/train"):
        assert phases[phase]["count"] >= 2
    assert tr["comm_bytes"]["broker/bytes_in"] > 0
    stitched = [s for s in tr["stitched_spans"] if s["name"] == "round/1/client/9/train"]
    publisher = next(s for s in ttel.load_spans(run_dir) if s["name"] == "round/1/sync")
    assert stitched and stitched[0]["trace_id"] == publisher["trace_id"]
    assert stitched[0]["parent_id"] == publisher["span_id"]
    if side == "port":
        assert jr["compile_ms"] == tr["compile_ms"] == 0.0
        assert set(os.listdir(run_dir)) >= {"spans.jsonl", "events.jsonl", "telemetry.jsonl"}
    else:
        # programs.jsonl is joined into the reference's attribution section
        assert tr["attribution"] == jr["attribution"] and tr["attribution"]["programs"]


def _sections(text):
    return {line.split(":")[0] for line in text.splitlines()
            if line and not line.startswith(" ")}


def test_report_cli_prints_the_references_sections(tmp_path, capsys):
    from click.testing import CliRunner

    from fedml_tpu.cli import cli as jcli
    from fedml_tpu_torch import cli as tcli

    run_dir = _acceptance_run_dir("port", tmp_path)
    assert tcli.main(["telemetry", "report", run_dir]) == 0
    out = capsys.readouterr().out
    res = CliRunner().invoke(jcli, ["telemetry", "report", run_dir])
    assert res.exit_code == 0, res.output
    assert _sections(out) == _sections(res.output)
    for want in ("round 0: wall", "round 1: wall", "p50 ms", "broker/bytes_in",
                 "cross-process stitched spans"):
        assert want in out
    assert tcli.main(["telemetry", "report", run_dir, "--json"]) == 0
    port_json = json.loads(capsys.readouterr().out)
    jres = CliRunner().invoke(jcli, ["telemetry", "report", run_dir, "--json"])
    jax_json = json.loads(jres.output)
    assert sorted(port_json) == sorted(jax_json)
    for key in ("rounds", "phases", "comm_bytes", "stitched_spans", "n_spans"):
        assert port_json[key] == jax_json[key], key


def test_report_cli_exits_nonzero_on_an_empty_dir(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "fedml_tpu_torch.cli", "telemetry", "report",
                           str(tmp_path)], cwd=REPO, env=_env(), capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 1 and "no spans" in proc.stdout


def test_partial_run_dir_reports_with_notes(tmp_path):
    ttel.MetricsRegistry().flush_jsonl(str(tmp_path))  # empty snapshot
    reg = ttel.MetricsRegistry()
    reg.counter("comm/raw_bytes").inc(100)
    reg.counter("comm/wire_bytes_out").inc(25)
    reg.flush_jsonl(str(tmp_path))
    jr, tr = _same_report(str(tmp_path))
    assert tr["notes"]["spans"] == jr["notes"]["spans"]
    assert tr["compression"]["ratio"] == 4.0
    text = ttel.format_report(tr)
    assert "spans.jsonl/events.jsonl missing" in text and "ratio 4.00x" in text


# -- tracing changes no number ----------------------------------------------------
@pytest.mark.parametrize("codec", ["", "int8"])
def test_sp_parameters_bit_equal_with_tracing_on_and_off(codec, tmp_path, untraced):
    on = _port_sp(_sp_cfg("on", tmp_path, compression=codec))
    ttel.reset_tracer()
    untraced()
    off = _port_sp(_sp_cfg("off", tmp_path, compression=codec, sys_perf_profiling=False))
    for k, v in on.global_params.items():
        assert torch.equal(v, off.global_params[k]), k
    assert os.path.exists(tmp_path / "run_on" / "spans.jsonl")
    assert not os.path.exists(tmp_path / "run_off")
    names = {r["name"] for r in _read_jsonl(tmp_path / "run_on" / "spans.jsonl")}
    assert {"round/0/sample", "round/0/train", "round/0/aggregate", "round/0/eval",
            "round/1/eval"} <= names
    assert sum(n.startswith("round/0/client/") for n in names) == 3
    events = _read_jsonl(tmp_path / "run_on" / "events.jsonl")
    assert [e["name"] for e in events] == ["event/train", "event/aggregate"] * 2


def test_sp_spans_equal_the_references_names(tmp_path):
    _port_sp(_sp_cfg("names_p", tmp_path))
    _jax_sp(_sp_cfg("names_j", tmp_path))
    jtel.get_tracer().flush()
    port = sorted(r["name"] for r in _read_jsonl(tmp_path / "run_names_p" / "spans.jsonl")
                  if "duration_ms" in r)
    ref = sorted(r["name"] for r in _read_jsonl(tmp_path / "run_names_j" / "spans.jsonl")
                 if "duration_ms" in r)
    assert port == ref


# -- cross-silo spans -----------------------------------------------------------------
def _cs_cfg(run_id, log_dir, comm=None, **train):
    cfg = {
        "common_args": {"training_type": "cross_silo", "random_seed": 0,
                        "run_id": run_id, "log_file_dir": str(log_dir)},
        "data_args": {"dataset": "synthetic", "train_size": 400, "test_size": 100,
                      "class_num": 5, "feature_dim": 16},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": 2, "epochs": 1,
                       "batch_size": 32, "learning_rate": 0.3, **train},
    }
    if comm:
        cfg["comm_args"] = comm
    return cfg


def _inproc_cs(cfg):
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.cross_silo.run_inproc import run_cross_silo_inproc
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.resilience.durability.recover import digest

    args = fedml_tpu_torch.init(load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = load_federated(args)
    captured = {}
    from fedml_tpu_torch.cross_silo.server import fedml_server_manager as fsm

    finish = fsm.FedMLServerManager.finish

    def recording_finish(self):
        captured["digest"] = digest(self.aggregator.get_global_model_params())
        finish(self)

    fsm.FedMLServerManager.finish = recording_finish
    try:
        result = run_cross_silo_inproc(args, ds, create(args, ds.class_num), device="cpu")
    finally:
        fsm.FedMLServerManager.finish = finish
    return result, captured["digest"]


@pytest.mark.parametrize("codec", ["", "int8"])
def test_cross_silo_digest_equal_with_tracing_on_and_off(codec, tmp_path, untraced):
    on, d_on = _inproc_cs(_cs_cfg("cs_on", tmp_path, compression=codec))
    ttel.reset_tracer()
    untraced()
    off, d_off = _inproc_cs(_cs_cfg("cs_off", tmp_path, compression=codec,
                                    sys_perf_profiling=False))
    assert d_on == d_off and on["rounds"] == off["rounds"] == 2
    assert on["test_loss"] == off["test_loss"]
    assert os.path.exists(tmp_path / "run_cs_on" / "spans.jsonl")
    assert not os.path.exists(tmp_path / "run_cs_off" / "spans.jsonl")


def test_inproc_server_round_trace_reaches_every_client(tmp_path):
    _inproc_cs(_cs_cfg("cs_trace", tmp_path))
    recs = _read_jsonl(tmp_path / "run_cs_trace" / "spans.jsonl")
    spans = [r for r in recs if "duration_ms" in r]
    by_id = {r["span_id"]: r for r in spans}
    sync0 = next(r for r in spans if r["name"] == "round/0/sync")
    trains = [r for r in spans if "/client/" in r["name"]]
    assert sorted(r["name"] for r in trains) == sorted(
        f"round/{n}/client/{c}/train" for n in (0, 1) for c in (1, 2, 3))
    for r in trains:
        assert r["trace_id"] == sync0["trace_id"]
        dispatch = by_id[r["parent_id"]]
        assert dispatch["name"] == "comm/dispatch" and dispatch["remote_parent"]
        sync = by_id[dispatch["parent_id"]]
        assert sync["name"] == f"round/{r['name'].split('/')[1]}/sync"
    for name in ("round/0/aggregate", "round/0/eval", "round/1/aggregate", "round/1/eval"):
        assert any(r["name"] == name for r in spans)
    sends = [r for r in recs if r.get("point") and r["name"] == "comm/send"]
    recvs = [r for r in recs if r.get("point") and r["name"] == "comm/recv"]
    assert sends and {r["attrs"]["msg_id"] for r in recvs} <= {
        r["attrs"]["msg_id"] for r in sends}
    metrics = _read_jsonl(tmp_path / "run_cs_trace" / "metrics.jsonl")
    assert {"event": "server.init_sent", "round": 0}.items() <= metrics[0].items()
    assert [m["round"] for m in metrics[1:]] == [0, 1] and "test_loss" in metrics[1]


def test_the_telemetry_header_crosses_both_packages_wires():
    """``telemetry_ctx`` rides the port's ``safe_dumps`` and the JAX
    package's unchanged, and each side reads the other's."""
    from fedml_tpu.utils import serialization as jser
    from fedml_tpu_torch.utils import serialization as tser

    with ttel.Tracer().span("round/0/sync"):
        params = {"msg_type": "x", "round": 0}
        ttel.inject_context(params)
    wire = tser.safe_dumps(params)
    assert wire == jser.safe_dumps(params)
    assert jser.safe_loads(wire) == tser.safe_loads(wire) == params
    assert jtel.extract_context(jser.safe_loads(wire)).span_id == params["telemetry_ctx"][
        "span_id"]


CS_CHILD = textwrap.dedent(r"""
    import json, sys
    import fedml_tpu_torch
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    cfg, rank = json.loads(sys.argv[1]), int(sys.argv[2])
    args = load_arguments_from_dict(cfg)
    args.rank = rank
    fn = fedml_tpu_torch.run_cross_silo_server if rank == 0 else \
        fedml_tpu_torch.run_cross_silo_client
    out = fn(args, device="cpu")
    print("CHILD " + json.dumps({"rank": rank, "rounds": (out or {}).get("rounds")}),
          flush=True)
""")


def test_three_processes_over_the_broker_share_one_run_dir(tmp_path):
    """A server and 2 silos as OS processes over the port's broker, one
    shared ``log_file_dir``: each rank's spans land whole, stamped with its
    service; every silo-side handler span carries the server's round trace
    with a server span as parent; the report lists them as stitched."""
    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker

    broker = PubSubBroker().start()
    try:
        host, port = broker.address
        cfg = _cs_cfg("cs_procs", tmp_path, comm={
            "comm_backend": "BROKER", "broker_host": host, "broker_port": port,
            "object_store_dir": str(tmp_path / "store")},
            client_num_in_total=2, client_num_per_round=2, comm_round=1)
        procs = [subprocess.Popen([sys.executable, "-c", CS_CHILD, json.dumps(cfg), str(r)],
                                  cwd=REPO, env=_env(), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True) for r in range(3)]
        try:
            outs = [p.communicate(timeout=150) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    finally:
        broker.stop()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    run_dir = tmp_path / "run_cs_procs"
    recs = _read_jsonl(run_dir / "spans.jsonl")  # every line whole
    spans = [r for r in recs if "duration_ms" in r]
    assert {r["service"] for r in recs} == {"rank0", "rank1", "rank2"}
    server = {r["span_id"]: r for r in spans if r["service"] == "rank0"}
    sync = next(r for r in server.values() if r["name"] == "round/0/sync")
    silo_dispatch = [r for r in spans if r["service"] != "rank0"
                     and r["name"] == "comm/dispatch"]
    assert {r["service"] for r in silo_dispatch} == {"rank1", "rank2"}
    for r in silo_dispatch:
        assert r["trace_id"] == sync["trace_id"] and r["parent_id"] in server
        assert r["remote_parent"]
    for rank in (1, 2):
        train = next(r for r in spans if r["name"] == f"round/0/client/{rank}/train")
        assert train["service"] == f"rank{rank}" and train["trace_id"] == sync["trace_id"]
    report = ttel.build_report(str(run_dir))
    stitched = {(s["name"], s.get("service")) for s in report["stitched_spans"]}
    assert {("comm/dispatch", "rank1"), ("comm/dispatch", "rank2")} <= stitched
    assert ("comm/dispatch", "rank0") in stitched  # the uploads stitch back
    assert jtel.build_report(str(run_dir))["stitched_spans"] == report["stitched_spans"]


# -- FedLLM and FA -----------------------------------------------------------------------
@pytest.mark.parametrize("on_device", [False, True])
def test_fedllm_round_events_equal_the_references(on_device, tmp_path):
    from fedml_tpu.arguments import load_arguments_from_dict
    from fedml_tpu.data import load_federated
    from fedml_tpu.models.llm.llama import LlamaConfig as JLlamaConfig
    from fedml_tpu.train.llm.run_fedllm import FedLLMAPI as JFedLLMAPI
    from fedml_tpu_torch.data.data_loader import load_synthetic_lm
    from fedml_tpu_torch.models.llm.llama import LlamaConfig
    from fedml_tpu_torch.train.llm.run_fedllm import FedLLMAPI
    import jax.numpy as jnp

    def cfg(side):
        return {
            "common_args": {"training_type": "simulation", "random_seed": 0,
                            "run_id": f"llm_{side}", "log_file_dir": str(tmp_path)},
            "data_args": {"dataset": "synthetic_lm", "max_seq_length": 8,
                          "vocab_size": 32, "train_size": 32, "test_size": 8},
            "model_args": {"model": "llama", "model_size": "tiny", "lora_rank": 4},
            "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                           "client_num_per_round": 2, "comm_round": 2, "epochs": 1,
                           "batch_size": 4, "per_device_batch_size": 4,
                           "learning_rate": 5e-3, "frequency_of_the_test": 1,
                           "on_device_round": on_device,
                           # the reference's mesh over the 8 virtual devices; the
                           # port's is one device (meshes are ROADMAP A11)
                           **({"mesh_dp": 1, "mesh_fsdp": 4, "mesh_tp": 2, "mesh_sp": 1}
                              if side == "jax" else
                              {"mesh_dp": 1, "mesh_fsdp": 1, "mesh_tp": 1, "mesh_sp": 1})},
        }

    jargs = fedml_tpu.init(load_arguments_from_dict(cfg("jax")))
    japi = JFedLLMAPI(jargs, None, load_federated(jargs),
                      cfg=JLlamaConfig.tiny(lora_rank=4, vocab_size=32, dtype=jnp.float32))
    japi.train()
    japi.event.flush()
    targs = fedml_tpu_torch.init(
        targuments.load_arguments_from_dict(cfg("port")))
    tapi = FedLLMAPI(targs, "cpu", load_synthetic_lm(targs),
                     cfg=LlamaConfig.tiny(lora_rank=4, vocab_size=32, dtype=torch.float32))
    out = tapi.train()
    port = _read_jsonl(tmp_path / "run_llm_port" / "events.jsonl")
    ref = _read_jsonl(tmp_path / "run_llm_jax" / "events.jsonl")
    assert [(e["name"], e["attrs"]) for e in port] == [(e["name"], e["attrs"]) for e in ref]
    assert [e["attrs"]["edge_id"] for e in port] == [0, 1]
    assert [sorted(e) for e in port] == [sorted(e) for e in ref]
    # the event brackets exactly the round the report's phase reads
    report = ttel.build_report(str(tmp_path / "run_llm_port"))
    (phase,) = [p for p in report["phases"] if p["phase"] == "event/round"]
    assert phase["count"] == 2 and np.isfinite(out["test_loss"])


def _fa_records(side, case, tmp_path):
    from test_torch_fa import _RESILIENCE, _managers, _run_side

    if side == "jax":
        from fedml_tpu.core.mlops import metrics as mm
    else:
        from fedml_tpu_torch.core.mlops import metrics as mm
    kw, n, raises = _RESILIENCE[case]
    sink = tmp_path / side
    mm._GLOBAL = mm.MLOpsMetrics(sink_dir=str(sink))
    try:
        mgrs, rid = _managers(side, "frequency_estimation", n, run_id=f"mlops_{case[:5]}",
                              **kw)
        if raises:
            with pytest.raises(RuntimeError, match=raises):
                _run_side(side, mgrs, rid)
        else:
            _run_side(side, mgrs, rid)
    finally:
        mm._GLOBAL.close()
        mm._GLOBAL = None
    return _read_jsonl(sink / "metrics.jsonl")


@pytest.mark.parametrize("case", ["quorum close", "abort below quorum"])
def test_fa_mlops_records_equal_the_references(case, tmp_path):
    port, ref = _fa_records("torch", case, tmp_path), _fa_records("jax", case, tmp_path)
    strip = [{k: v for k, v in r.items() if k != "ts"} for r in port]
    assert [sorted(r) for r in port] == [sorted(r) for r in ref]
    assert strip == [{k: v for k, v in r.items() if k != "ts"} for r in ref]
    events = [r.get("event") for r in port]
    if case == "quorum close":
        assert events == ["fa.quorum_close", None]
        assert port[0]["missing"] == "3" and port[1]["fa_task"] == "frequency_estimation"
    else:
        assert events == ["fa.abort"] and port[0]["missing"] == "1,2"


# -- the taxonomy lint ------------------------------------------------------------------
def test_port_span_and_metric_names_pass_the_references_lint(monkeypatch):
    from fedml_tpu.analysis.passes import span_names

    monkeypatch.setattr(span_names, "ROOTS", ("fedml_tpu_torch",))
    entries = span_names.collect()
    assert all("fedml_tpu_torch" in path for path, *_ in entries)
    names = {name for *_, name in entries}
    assert {"round/<v>/sample", "round/<v>/client/<v>/train", "comm/dispatch",
            "round/<v>/sync", "build/compile_ms"} <= names
    problems = span_names._check_structured(entries)
    assert problems == [], problems
