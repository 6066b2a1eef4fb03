"""The port's device-side profiling (``fedml_tpu_torch.telemetry.profiling``,
``telemetry.device_stats``) against the JAX package's, on the CPU.

What must be equal, and how:

* the roofline: ``arithmetic_intensity``, ``classify``, ``ridge_point`` and
  ``build_attribution`` give equal results for the same inputs under the
  ``FEDML_PEAK_*`` overrides and for a device neither table names; the
  whole-run ``provenance`` says whose figures a run dir holds (``xla`` for
  the reference's rows, ``counted`` for the port's);
* ``parse_rounds`` accepts and rejects the same specs;
* the trace controller: the same sequence of arms, requests, budgets,
  round hooks and manual starts lands the same ``profile_capture`` markers
  (kind, round, rule, in order) in both packages;
* the catalog: the ``programs.jsonl`` rows of a 2-round sp run have the
  reference's keys and the same calls, signatures, recompiles and phase
  calls; ``FEDML_PROFILE=0`` turns both off; the port's FLOPs are the
  analytic count of its products and attention, exactly;
* the report: either package's report over either package's run dir gives
  the same attribution section; ``mem_sample`` records have the
  reference's keys and phases;
* profiling changes no number: an sp run with a traced round is bit-equal
  to one with the catalog off.
"""
import copy
import json
import os
import sys

import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import telemetry as jtel
from fedml_tpu.telemetry import health as jhealth
from fedml_tpu.telemetry.profiling import catalog as jcat
from fedml_tpu.telemetry.profiling import roofline as jroof
from fedml_tpu.telemetry.profiling import trace as jtrace
from fedml_tpu_torch import telemetry as ttel
from fedml_tpu_torch.telemetry import health as thealth
from fedml_tpu_torch.telemetry.profiling import catalog as tcat
from fedml_tpu_torch.telemetry.profiling import roofline as troof
from fedml_tpu_torch.telemetry.profiling import trace as ttrace


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
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# -- roofline ------------------------------------------------------------------
_PHASES = [{"phase": "round/<n>/train", "total_ms": 400.0},
           {"phase": "round/<n>/aggregate", "total_ms": 50.0},
           {"phase": "round/<n>/eval", "total_ms": 30.0},
           {"phase": "comm/dispatch", "total_ms": 7.0}]
_ROUNDS = [{"round": 0, "wall_ms": 300.0}, {"round": 1, "wall_ms": 250.0}]


def _programs(treedef):
    return [
        {"name": "sp/local_train", "flops": 3.0e9, "bytes_accessed": 1.5e8,
         "peak_hbm_bytes": 2.0e8, "compile_ms": 1.5, "recompiles": 0, "calls": 6,
         "multi_shape": False, "mesh_spec": None, "treedef": treedef,
         "phase_calls": {"round/<n>/client/<id>/train": 6}},
        {"name": "compress/encode", "flops": 0.0, "bytes_accessed": 4.0e7,
         "peak_hbm_bytes": 0.0, "calls": 6, "multi_shape": True, "treedef": treedef,
         "phase_calls": {"compress/encode": 6}},
        {"name": "sp/evaluate", "flops": 2.0e8, "bytes_accessed": 1.0e7,
         "peak_hbm_bytes": 5.0e7, "calls": 2, "recompiles": 1, "multi_shape": True,
         "treedef": treedef, "phase_calls": {"round/<n>/eval": 2}},
        {"name": "integrity/accept_check", "flops": 1.0, "bytes_accessed": 0.0,
         "calls": 0, "phase_calls": {}},
    ]


_PEAK_ENVS = [
    pytest.param({}, id="no-peaks"),
    pytest.param({"FEDML_PEAK_FLOPS": "1e12", "FEDML_PEAK_BW": "1e11"}, id="both"),
    pytest.param({"FEDML_PEAK_FLOPS": "5e11"}, id="flops-only"),
    pytest.param({"FEDML_PEAK_BW": "2e11"}, id="bw-only"),
]


@pytest.mark.parametrize("env", _PEAK_ENVS)
@pytest.mark.parametrize("device_kind", [None, "cpu", "an unlisted card"])
def test_roofline_functions_equal_the_reference(env, device_kind, monkeypatch):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # device_kind None asks the runtime: no card here (port), cpu (JAX)
    assert troof.device_peaks(device_kind) == jroof.device_peaks(device_kind)
    assert troof.ridge_point() == jroof.ridge_point()
    for peaks in [(None, None), (1e12, None), (1e12, 1e11), (989e12, 3.35e12)]:
        assert troof.ridge_point(peaks) == jroof.ridge_point(peaks)
    for flops, nbytes in [(0, 5), (5, 0), (1e9, 3e7), (2.0, 7.0)]:
        assert (troof.arithmetic_intensity(flops, nbytes)
                == jroof.arithmetic_intensity(flops, nbytes))
    for ai in [None, 0.5, 9.99, 10.0, 295.2, 1e4]:
        for ridge in [None, 4.0, 295.22]:
            assert troof.classify(ai, ridge) == jroof.classify(ai, ridge)
    # the reference's rows (a JAX treedef): the same section, key for key
    jrows = _programs("PyTreeDef(((*, *), {}))")
    want = jroof.build_attribution(_PHASES, _ROUNDS, jrows, device_kind)
    got = troof.build_attribution(_PHASES, _ROUNDS, copy.deepcopy(jrows), device_kind)
    assert got == want
    # the port's rows: the same numbers, provenance "counted"
    trows = _programs("((*, LocalState(*, None, None, None)), {})")
    want = jroof.build_attribution(_PHASES, _ROUNDS, trows, device_kind)
    got = troof.build_attribution(_PHASES, _ROUNDS, copy.deepcopy(trows), device_kind)
    assert want["overall"].pop("provenance") == "xla"
    assert got["overall"].pop("provenance") == "counted"
    assert got == want


def test_the_card_tables_are_nvidia_only():
    assert troof.PEAK_BF16 is troof.PEAK_FLOPS
    assert set(troof.PEAK_FLOPS) == set(troof.PEAK_HBM_BW)
    assert all(k.startswith("NVIDIA ") for k in troof.PEAK_FLOPS)
    assert troof.device_peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert troof.ridge_point(troof.device_peaks("NVIDIA H100 80GB HBM3")) == \
        pytest.approx(295.2238806)
    # a TPU named by a JAX run dir is an unknown device to the port
    assert troof.device_peaks("TPU v5e") == (None, None)
    assert troof.ridge_point(troof.device_peaks("TPU v5e")) == troof.DEFAULT_RIDGE


@pytest.mark.parametrize("spec", [None, "", "0", "1,3", " 2 , 5,", "7,7", 4,
                                  "-1", "1;2", "a", "1,b", "1.5", "[1]"])
def test_parse_rounds_accepts_and_rejects_the_same_specs(spec):
    try:
        want = jtrace.parse_rounds(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ttrace.parse_rounds(spec)
        assert str(got.value) == str(e)
    else:
        assert ttrace.parse_rounds(spec) == want


# -- the trace controller ----------------------------------------------------------
def _controller_sequence(mod, base):
    """Arms, requests, budgets and round hooks through one package's
    controller; returns (request answers, markers as (kind, round, rule),
    refusals while a trace records)."""
    tc = mod.TraceController(max_captures=3, trace_dir=str(base))
    answers = [tc.request_capture("straggler", "slow client 2", round_idx=0),
               tc.request_capture("straggler", "again"),      # one per rule
               tc.request_capture("memory_growth", "slope"),
               tc.request_capture("stale_serving_round"),
               tc.request_capture("slo_burn")]                # count budget
    tc.arm_rounds([2])
    busy = []
    for r in range(4):
        started = tc.on_round_start(r)
        if started:
            busy.append(tc.start_manual(str(base / "owner")))  # single owner
            busy.append(tc.on_round_start(r + 100))            # still this round's
        tc.on_round_end(r)
    assert tc.unavailable is None
    tc.byte_budget = 1  # spent: the next request is refused
    answers.append(tc.request_capture("late_rule"))
    tc.finish()
    return answers, [(m["kind"], m["round"], m["rule"]) for m in tc.captures], busy, tc


def test_trace_controller_sequence_equals_the_reference(tmp_path):
    ja, jm, jb, _ = _controller_sequence(jtrace, tmp_path / "jax")
    ta, tm, tb, tc = _controller_sequence(ttrace, tmp_path / "port")
    assert ta == ja == [True, False, True, True, False, False]
    assert tm == jm == [("profile_capture", 0, "straggler"),
                        ("profile_capture", 1, "memory_growth"),
                        ("profile_capture", 2, "explicit"),
                        ("profile_capture", 3, "stale_serving_round")]
    assert tb == jb == [False, True] * 4
    for m in tc.captures:
        assert m["ok"] and m["trace_bytes"] > 0
        assert os.path.exists(os.path.join(m["trace_dir"], "trace.json"))
    assert tc.bytes_captured == sum(m["trace_bytes"] for m in tc.captures)
    assert ttrace.AUTO_CAPTURE_RULES == jtrace.AUTO_CAPTURE_RULES


def test_budget_env_and_args_knobs_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setenv("FEDML_TRACE_MAX_CAPTURES", "2")
    monkeypatch.setenv("FEDML_TRACE_BYTE_BUDGET", "1234")
    monkeypatch.setenv("FEDML_TRACE_ROUNDS", "0,4")
    monkeypatch.setenv("FEDML_TRACE_DIR", str(tmp_path))
    for mod in (jtrace, ttrace):
        tc = mod.TraceController()
        assert (tc.max_captures, tc.byte_budget, tc._armed_rounds, tc._trace_dir) == (
            2, 1234, {0, 4}, str(tmp_path))

    class A:
        run_id = "knobs"
        log_file_dir = str(tmp_path)
        trace_max_captures = 1
        trace_byte_budget = 99
        trace_rounds = "3"
        trace_dir = str(tmp_path / "tr")

    ttel.configure_from_args(A())
    jtel.configure_from_args(A())
    for tc in (ttrace.get_trace_controller(), jtrace.get_trace_controller()):
        assert (tc.max_captures, tc.byte_budget, 3 in tc._armed_rounds, tc._trace_dir) == (
            1, 99, True, str(tmp_path / "tr"))


def test_manual_trace_through_the_mlops_facade_equals_the_reference(tmp_path):
    from fedml_tpu.core.mlops.event import MLOpsProfilerEvent as JEvent
    from fedml_tpu_torch.core.mlops.event import MLOpsProfilerEvent as TEvent

    out = []
    for side, cls, tmod in (("jax", JEvent, jtrace), ("port", TEvent, ttrace)):
        class A:
            run_id = f"manual_{side}"
            log_file_dir = str(tmp_path / side)
            jax_trace_dir = str(tmp_path / side / "deep")

        ev = cls(A())
        assert ev.start_trace() is True
        assert tmod.get_trace_controller().start_manual(str(tmp_path / "x")) is False
        m = ev.stop_trace()
        assert m["trace_dir"] == A.jax_trace_dir and m["ok"]
        assert ev.stop_trace() is None  # nothing left to stop
        out.append((m["kind"], m["round"], m["rule"], m["reason"]))
        ring = [json.loads(line) for line in (
            jtel if side == "jax" else ttel).get_flight_recorder()._lines]
        assert any(e.get("kind") == "profile_capture" and e.get("rule") == "manual"
                   for e in ring)
    assert out[0] == out[1] == ("profile_capture", -1, "manual", "mlops facade")
    assert os.path.exists(tmp_path / "port" / "deep" / "trace.json")


# -- the catalog ---------------------------------------------------------------------
def test_catalog_counts_products_and_keeps_results():
    a, b = torch.randn(8, 16), torch.randn(16, 4)

    def f(p, x):
        return {"w": p["w"] * 1.5 + 1.0}, (x @ b).sum()

    w = tcat.wrap_program("test/f", f)
    p = {"w": torch.arange(12.0).reshape(3, 4)}
    raw = f(p, a)
    for _ in range(3):
        got = w(p, a)
    assert torch.equal(got[0]["w"], raw[0]["w"]) and torch.equal(got[1], raw[1])
    rec = w.record.to_dict()
    assert set(rec) == set(jcat.ProgramRecord("x").to_dict())
    assert rec["calls"] == 3 and rec["n_signatures"] == 1 and rec["recompiles"] == 0
    assert rec["flops"] == 2 * 8 * 16 * 4  # one mm; elementwise work uncounted
    # bytes: every op's inputs and outputs (mul, add, mm, sum), f32
    assert rec["bytes_accessed"] == 4 * ((12 + 12) + (12 + 12) + (128 + 64 + 32) + (32 + 1))
    assert rec["argument_bytes"] == 4 * (12 + 128)
    assert rec["output_bytes"] == 4 * (12 + 1)
    assert rec["peak_hbm_bytes"] == 0.0  # the CPU
    assert rec["phase_calls"] == {"unattributed": 3}
    assert rec["treedef"] == "(({w: *}, *), {})"
    assert rec["fallback_calls"] == 0 and rec["analysis_error"] is None
    with ttel.get_tracer().span("round/3/client/7/train"):
        w(p, a)
    assert w.record.phase_calls["round/<n>/client/<id>/train"] == 1


def test_signatures_static_args_and_the_disabled_passthrough(monkeypatch):
    calls = []

    def g(scale, x):
        calls.append(scale)
        return x * scale

    w = tcat.wrap_program("test/g", g, static_argnums=(0,), multi_shape=True)
    w(2.0, torch.ones(3))
    w(2.0, torch.ones(3))
    w(3.0, torch.ones(3))   # a new static value: a new variant
    w(3.0, torch.ones(4))   # a new shape
    w(3.0, torch.ones(4, dtype=torch.float64))  # a new dtype
    rec = w.record.to_dict()
    assert (rec["calls"], rec["n_signatures"], rec["recompiles"], rec["multi_shape"]) == (
        5, 4, 3, True)
    assert ttel.get_registry().counter("profile/recompiles",
                                       labels={"program": "test/g"}).value == 3
    monkeypatch.setenv("FEDML_PROFILE", "0")
    tcat.reset_catalog()
    assert not tcat.get_catalog().enabled
    out = w(5.0, torch.ones(2))
    assert torch.equal(out, torch.full((2,), 5.0)) and calls[-1] == 5.0
    assert w.record.calls == 0  # re-homed into the disabled catalog, untouched


def test_nested_programs_count_for_the_outer_one_and_builds_are_booked():
    inner = tcat.wrap_program("test/inner", lambda x: x @ x)

    def outer_fn(x):
        ttel.note_kernel_build("fake.cu", 12.5)  # a first-use build inside
        return inner(inner(x))

    outer = tcat.wrap_program("test/outer", outer_fn)
    x = torch.randn(5, 5)
    outer(x)
    outer(x)
    assert inner.record.calls == 0 and inner.record.n_signatures == 0
    rec = outer.record.to_dict()
    assert rec["calls"] == 2 and rec["flops"] == 2 * (2 * 5 * 5 * 5)
    assert rec["compile_events"] == 2 and rec["compile_ms"] == 25.0
    inner(x)  # outside any program: its own call
    assert inner.record.calls == 1
    ttel.note_kernel_build("fake.cu", 1.0)
    assert tcat.get_catalog().uncataloged_compiles == 1


def test_the_catalog_keeps_no_owner_alive():
    """A program wraps its owner's bound method (a trainer's step, an
    engine's decode): once the owner is gone, the catalog holds neither it
    nor its model, and its record stays."""
    import gc
    import weakref

    class Owner:
        def __init__(self):
            self.weights = torch.ones(1024)
            self.step = tcat.wrap_program("test/owner_step", self._step)

        def _step(self, x):
            return x * self.weights

    owner = Owner()
    owner.step(torch.ones(1024))
    alive = weakref.ref(owner.weights)
    del owner
    gc.collect()
    assert alive() is None
    assert "test/owner_step" not in tcat.get_catalog()._programs
    assert tcat.get_catalog().snapshot()[-1]["name"] == "test/owner_step"


@pytest.mark.parametrize("fed_opt", ["FedAvg", "FedProx", "Mime"])
def test_repeated_steps_count_once_and_equal_the_full_count(fed_opt, monkeypatch):
    """The local steps are counted one of each kind (valid, padded) and
    taken for every step: the same FLOPs and bytes as counting them all."""
    import contextlib
    import types

    from fedml_tpu_torch.ml.trainer import local_sgd

    args = types.SimpleNamespace(federated_optimizer=fed_opt, learning_rate=0.1,
                                 client_optimizer="sgd", momentum=0.9)

    def apply_fn(params, x):
        return x @ params["w"] + params["b"]

    params = {"w": torch.randn(6, 4), "b": torch.zeros(4)}
    state = local_sgd.init_local_state(params, args)
    if fed_opt == "Mime":
        state = state._replace(c_global={k: torch.zeros_like(v) for k, v in params.items()})
    gen = torch.Generator().manual_seed(0)
    xs, ys = torch.randn(7, 5, 6, generator=gen), torch.randint(0, 4, (7, 5), generator=gen)
    mask = torch.ones(7, 5)
    mask[5:] = 0  # two padded steps

    def count():
        run_local = local_sgd.build_local_fn(apply_fn, args)._fn  # unwrapped
        counter = tcat._CostCounter()
        with counter:
            out = run_local(params, state, xs, ys, mask)
        return counter.flops, counter.bytes, out

    sampled = count()
    monkeypatch.setattr(local_sgd, "repeated_cost",
                        lambda kind, n: contextlib.nullcontext())
    full = count()
    assert sampled[:2] == full[:2] and sampled[0] > 0
    for k in params:
        assert torch.equal(sampled[2][0][k], full[2][0][k])


def test_kernel_cost_replaces_the_plain_versions_count():
    from fedml_tpu_torch.ops import flash_attention as fa

    q = torch.randn(1, 4, 16, 8)
    k, v = torch.randn(1, 2, 16, 8), torch.randn(1, 2, 16, 8)
    fwd = tcat.wrap_program("test/flash", lambda q, k, v: fa.flash_attention(q, k, v))
    fwd(q, k, v)
    costs = fa.kernel_costs(q, k, True)
    pairs = 16 * 17 // 2
    assert costs["fwd"][0] == 4 * 4 * 8 * pairs
    # the declared cost, and none of the plain version's ops
    assert (fwd.record.flops, fwd.record.bytes_accessed) == costs["fwd"]
    assert costs["fwd"][1] == 4 * (2 * 4 * 16 * 8 + 2 * 2 * 16 * 8) + 4 * 4 * 16


# -- an sp run through both packages -------------------------------------------------
def _sp_cfg(run_id, log_dir, **train):
    cfg = {
        "common_args": {"training_type": "simulation", "random_seed": 0,
                        "run_id": run_id, "log_file_dir": str(log_dir)},
        "data_args": {"dataset": "synthetic", "partition_method": "hetero",
                      "partition_alpha": 0.5, "train_size": 200, "test_size": 80,
                      "class_num": 5, "feature_dim": 7},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": 2, "epochs": 1,
                       "batch_size": 16, "learning_rate": 0.3, "compression": "int8"},
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
    jtel.flush_run()
    return api


@pytest.fixture(scope="module")
def sp_run_dirs(tmp_path_factory):
    """One 2-round int8 sp run of each package, into its own run dir. The
    model's widths (7 features, 5 classes) are this file's own: the
    reference's module-level programs keep their compiled variants across
    catalog resets, so widths another test in the process ran would show
    there as no new signature."""
    base = tmp_path_factory.mktemp("sp")
    _reset_port()
    _port_sp(_sp_cfg("prof_p", base))
    _jax_sp(_sp_cfg("prof_j", base))
    _reset_port()
    return str(base / "run_prof_p"), str(base / "run_prof_j")


_COMPARED = ("calls", "n_signatures", "recompiles", "phase_calls", "multi_shape")


def test_sp_programs_jsonl_equals_the_references(sp_run_dirs):
    port_dir, jax_dir = sp_run_dirs
    port = {r["name"]: r for r in _read_jsonl(os.path.join(port_dir, "programs.jsonl"))}
    ref = {r["name"]: r for r in _read_jsonl(os.path.join(jax_dir, "programs.jsonl"))}
    assert set(port) == set(ref) >= {"sp/local_train", "sp/evaluate", "compress/ef_encode",
                                     "compress/fused_weighted_sum"}
    for name, row in port.items():
        assert set(row) == set(ref[name]), name  # key for key
        assert {k: row[k] for k in _COMPARED} == {k: ref[name][k] for k in _COMPARED}, name
        assert row["device_kind"] == row["platform"] == "cpu"
        assert row["bytes_accessed"] > 0
    assert port["sp/local_train"]["calls"] == 6
    assert port["sp/local_train"]["phase_calls"] == {"round/<n>/client/<id>/train": 6}
    assert port["sp/evaluate"]["multi_shape"] is True
    # against XLA's cost_analysis() of the same program: the port counts
    # the LR model's products of every step its first client ran (2·B·F·C
    # forward, the same again for the weight gradient: 2240 FLOPs a step),
    # XLA counts the body of the program's scan over the steps once, with
    # its elementwise work (softmax, cross-entropy, the SGD update, the
    # mask). So the ratio lies between 1 and the port's step count:
    # recorded 2.22 at this config (4 steps), bound [1, steps].
    flops = port["sp/local_train"]["flops"]
    steps, rest = divmod(flops, 2 * 2 * 16 * 7 * 5)
    assert rest == 0 and steps >= 1
    ratio = flops / ref["sp/local_train"]["flops"]
    assert 1.0 <= ratio <= steps, (ratio, steps)


def test_profiling_off_writes_no_catalog_in_either_package(tmp_path, monkeypatch):
    monkeypatch.setenv("FEDML_PROFILE", "0")
    tcat.reset_catalog()
    jcat.reset_catalog()
    _port_sp(_sp_cfg("off_p", tmp_path, comm_round=1))
    _jax_sp(_sp_cfg("off_j", tmp_path, comm_round=1))
    ttel.flush_run()
    for side in ("p", "j"):
        run_dir = tmp_path / f"run_off_{side}"
        assert os.path.exists(run_dir / "spans.jsonl")
        assert not os.path.exists(run_dir / "programs.jsonl")
    monkeypatch.delenv("FEDML_PROFILE")
    jcat.reset_catalog()


@pytest.mark.parametrize("reader", ["port", "jax"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_attribution_section_over_either_packages_run_dir(reader, writer, sp_run_dirs,
                                                          monkeypatch):
    monkeypatch.setenv("FEDML_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("FEDML_PEAK_BW", "1e11")
    run_dir = sp_run_dirs[0 if writer == "port" else 1]
    tr, jr = ttel.build_report(run_dir), jtel.build_report(run_dir)
    got, want = (tr, jr) if reader == "port" else (jr, tr)
    ga, wa = copy.deepcopy(got["attribution"]), copy.deepcopy(want["attribution"])
    assert ga["programs"] and ga["phases"]
    if writer == "port":
        # the reference labels every catalog "xla"; the port knows its own
        assert tr["attribution"]["overall"]["provenance"] == "counted"
        ga["overall"].pop("provenance"), wa["overall"].pop("provenance")
    assert ga == wa
    train = next(p for p in ga["phases"] if p["phase"] == "round/<n>/client/<id>/train")
    assert train["calls"] == 6 and train["mfu"] == pytest.approx(
        train["achieved_flops_per_s"] / 1e12)
    text = (ttel if reader == "port" else jtel).format_report(got)
    assert "performance attribution (cpu, roofline ridge 10.0 flop/byte)" in text
    assert "sp/local_train" in text


def test_mem_samples_match_the_references_schema(sp_run_dirs):
    port_dir, jax_dir = sp_run_dirs
    port = [r for r in _read_jsonl(os.path.join(port_dir, "health.jsonl"))
            if r["kind"] == "mem_sample"]
    ref = [r for r in _read_jsonl(os.path.join(jax_dir, "health.jsonl"))
           if r["kind"] == "mem_sample"]
    assert [(r["phase"], r["round"]) for r in port] == [(r["phase"], r["round"]) for r in ref]
    assert [r["phase"] for r in port] == ["train", "aggregate", "eval"] * 2
    for p, j in zip(port, ref):
        assert set(p) == set(j)
        assert p["host_rss_bytes"] > 0 and p["device_stats_available"] is False
    snap = ttel.memory_snapshot()
    assert set(snap) == set(jtel.memory_snapshot()) - {"utilization"}


def test_sampler_gauges_and_build_cache_counters(tmp_path, monkeypatch):
    from fedml_tpu_torch.ops import _build
    from fedml_tpu_torch.telemetry import device_stats

    ttel.configure(str(tmp_path / "run"), service="t")
    sampler = device_stats.DeviceStatsSampler(min_interval_s=60.0)
    assert sampler.sample("train", 4) is not None
    assert sampler.sample("train", 5) is None  # rate-limited per phase
    reg = ttel.get_registry()
    assert reg.gauge("mem/host_rss_bytes", labels={"phase": "train"}).value > 0
    rec = _read_jsonl(tmp_path / "run" / "health.jsonl")
    assert [(r["kind"], r["phase"], r["round"]) for r in rec] == [("mem_sample", "train", 4)]
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "b")
    monkeypatch.setattr(_build, "find_cxx", lambda: sys.executable)  # never reached
    out = _build.library_path("lcc", ".cpp", _build.CXX_FLAGS)
    out.parent.mkdir(parents=True)
    out.touch()
    assert _build.build_host("lcc") == out
    assert reg.counter("build/cache_hits").value == 1
    assert reg.counter("build/cache_requests").value == 1


def test_traced_sp_round_is_bit_equal_to_the_unprofiled_run(tmp_path, monkeypatch):
    traced = _port_sp(_sp_cfg("traced", tmp_path, trace_rounds="0"))
    caps = ttrace.get_trace_controller().captures
    assert [(c["round"], c["rule"], c["ok"]) for c in caps] == [(0, "explicit", True)]
    run_dir = tmp_path / "run_traced"
    assert caps[0]["trace_dir"] == str(run_dir / "traces" / "round0_explicit")
    events = json.load(open(os.path.join(caps[0]["trace_dir"], "trace.json")))["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    markers = [r for r in _read_jsonl(run_dir / "telemetry.jsonl")
               if r.get("kind") == "profile_capture"]
    assert [(m["round"], m["rule"]) for m in markers] == [(0, "explicit")]
    assert ttel.get_registry().counter("profile/captures",
                                       labels={"trigger": "explicit"}).value == 1
    _reset_port()
    monkeypatch.setenv("FEDML_PROFILE", "0")
    tcat.reset_catalog()
    plain = _port_sp(_sp_cfg("plain", tmp_path))
    assert not os.path.exists(tmp_path / "run_plain" / "programs.jsonl")
    assert os.path.exists(run_dir / "programs.jsonl")
    for k, v in traced.global_params.items():
        assert torch.equal(v, plain.global_params[k]), k


def test_telemetry_profile_cli_arms_the_env(tmp_path):
    from fedml_tpu_torch import cli as tcli

    out = tmp_path / "env.json"
    code = ("import json,os;"
            "json.dump({k:v for k,v in os.environ.items() if k.startswith('FEDML_TRACE')},"
            f" open({str(out)!r},'w'))")
    assert tcli.main(["telemetry", "profile", "--rounds", "1,3", "--trace-dir",
                      str(tmp_path / "tr"), "--", sys.executable, "-c", code]) == 0
    assert json.loads(out.read_text()) == {"FEDML_TRACE_ROUNDS": "1,3",
                                           "FEDML_TRACE_DIR": str(tmp_path / "tr")}
    assert tcli.main(["telemetry", "profile", "--", sys.executable, "-c",
                      "raise SystemExit(3)"]) == 3


def test_tree_trace_rounds_through_the_cli(tmp_path, monkeypatch, capsys):
    from fedml_tpu_torch import cli as tcli

    monkeypatch.chdir(tmp_path)
    assert tcli.main(["tree", "--clients", "40", "--tiers", "3", "--rounds", "3",
                      "--device", "cpu", "--trace-rounds", "0,2"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["completed"] is True
    caps = ttrace.get_trace_controller().captures
    assert [(c["round"], c["rule"], c["ok"]) for c in caps] == [(0, "explicit", True),
                                                              (2, "explicit", True)]
    assert all(os.path.exists(os.path.join(c["trace_dir"], "trace.json")) for c in caps)
    rows = {r["name"]: r for r in tcat.get_catalog().snapshot()}
    assert rows["hierarchy/leaf_chunk"]["calls"] > 0


# -- the LLM round: FLOPs against the analytic count ------------------------------------
def _analytic_step_flops(cfg, batch, t):
    """Products of one LoRA step of the port's Llama as autograd runs them:
    every projection forward; its activation gradient wherever its input
    needs one (not layer 0's q/k/v, whose input is the frozen embedding's);
    the adapters' forward, weight gradients and the input gradient of
    ``lora_a`` where the input needs one; the LM head forward and its
    activation gradient; flash attention's 4 + 6 + 8 FLOPs per (query, key)
    pair and head dim."""
    h, i, v, r = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size, cfg.lora_rank
    hq = cfg.num_attention_heads * cfg.head_dim
    kv = cfg.num_key_value_heads * cfg.head_dim
    n = batch * t
    adapters = [(h, hq), (h, kv), (h, kv), (hq, h)]  # q, k, v, o
    pairs = t * (t + 1) // 2
    total = 0
    for layer in range(cfg.num_hidden_layers):
        base = 2 * n * (h * hq + 2 * h * kv + hq * h + 3 * h * i)
        grad_in = base - (2 * n * (h * hq + 2 * h * kv) if layer == 0 else 0)
        lora = sum(2 * n * r * (din + dout)            # forward
                   + 2 * n * r * (din + 2 * dout)      # dA, dB and d(xA)
                   for din, dout in adapters)
        lora_dx = sum(2 * n * r * din for j, (din, _) in enumerate(adapters)
                      if layer > 0 or j == 3)
        attn = 18 * batch * cfg.num_attention_heads * cfg.head_dim * pairs
        total += base + grad_in + lora + lora_dx + attn
    return total + 4 * n * h * v


def test_fused_round_flops_equal_the_analytic_count_and_nest(tmp_path):
    from fedml_tpu_torch.models.llm.llama import LlamaConfig
    from fedml_tpu_torch.train.llm import trainer as ttrainer

    class Args:
        max_seq_length, per_device_batch_size, gradient_accumulation_steps = 16, 2, 1
        learning_rate, random_seed = 1e-2, 0

    cfg = LlamaConfig.tiny(lora_rank=4, dtype=torch.float32, num_hidden_layers=3)
    tr = ttrainer.LLMTrainer(cfg, Args(), device="cpu")
    tr.init(seed=0)
    n_clients, steps = 2, 3
    fed = tr.compile_federated_round(n_clients, steps)
    rng = np.random.default_rng(0)
    xs = rng.integers(0, cfg.vocab_size, (n_clients, steps, 2, 16))
    ys = rng.integers(0, cfg.vocab_size, (n_clients, steps, 2, 16))
    ms = np.ones((n_clients, steps, 2), np.float32)
    w = np.asarray([1.0, 3.0], np.float32)
    g = ttrainer.to_exchange(tr.model)
    with ttel.get_tracer().span("round/0/train"):
        _, _, g, _ = fed(tr.params, tr.opt_state, g, xs, ys, ms, w)
    _, _, g, _ = fed(tr.params, tr.opt_state, g, xs, ys, ms, w)
    tr.step(xs[0, :1], ys[0, :1], ms[0, :1])  # a step outside the round
    tr.evaluate(xs[0, 0], ys[0, 0])
    rows = {r["name"]: r for r in tcat.get_catalog().snapshot()}
    step = _analytic_step_flops(cfg, 2, 16)
    assert rows["llm/fused_round"]["flops"] == n_clients * steps * step
    assert rows["llm/fused_round"]["calls"] == 2 and rows["llm/fused_round"]["n_signatures"] == 1
    assert rows["llm/fused_round"]["phase_calls"] == {"round/<n>/train": 1, "unattributed": 1}
    # nesting: the round's steps count for the round alone
    assert rows["llm/train_step"]["calls"] == 1
    assert rows["llm/train_step"]["flops"] == step
    assert rows["llm/eval_step"]["calls"] == 1 and rows["llm/eval_step"]["multi_shape"]
    # chip_smoke's formula also counts layer 0's q/k/v input gradients and
    # lora_a's: 3.2% over at this size, 0.87% at phase s's 4 Llama-3-8B layers
    from chip_smoke import train_step_flops

    assert train_step_flops(cfg, 2, 16) == pytest.approx(step * 1.0325, rel=1e-3)
    big = LlamaConfig.llama3_8b(lora_rank=16, num_hidden_layers=4)
    assert train_step_flops(big, 1, 2048) == pytest.approx(
        _analytic_step_flops(big, 1, 2048), rel=0.02)
