"""The port's synchronous cross-silo FedAvg against the reference's on the
CPU, on the same seed and from the same initial weights
(``from_flax_params``):

* in-process federations over the LOCAL transport, with full (3 of 3) and
  partial (2 silos of 6) participation: the same silos each round, and per
  round the test loss and accuracy, and the final parameters, within the sp
  tests' ``TOL`` uncompressed, and within one quantization step of each
  leaf under int8 and topk uplinks (the bound of
  ``tests/test_torch_sp_simulation.py``);
* mixed federations over one TCP ``PubSubBroker`` in this process — a JAX
  server with port clients, and a port server with JAX clients — held to
  the all-JAX run by the same bounds, uncompressed and under int8;
* a round that closes at quorum after its deadline with one silo's trainer
  stalled, with the reference's missing list and aggregate; the silo then
  rejoins and its error feedback resets;
* the options the slice leaves out raise naming their ROADMAP item, and the
  entry points refuse a missing CUDA device and run on the CPU when asked.
"""
import copy
import threading
import types
import time

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import arguments as jarguments
from fedml_tpu.core.distributed.communication.broker import PubSubBroker as JBroker
from fedml_tpu.cross_silo.client.client import Client as JClient
from fedml_tpu.cross_silo.message_define import MyMessage as JMyMessage
from fedml_tpu.cross_silo.run_inproc import run_managers_to_completion as jrun
from fedml_tpu.cross_silo.server.server import Server as JServer
from fedml_tpu.data import data_loader as jdl
from fedml_tpu.models import model_hub as jhub
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker
from fedml_tpu_torch.cross_silo.client.client import Client
from fedml_tpu_torch.cross_silo.message_define import MyMessage
from fedml_tpu_torch.cross_silo.run_inproc import (
    build_cross_silo_inproc,
    run_managers_to_completion,
)
from fedml_tpu_torch.cross_silo.server.server import Server
from fedml_tpu_torch.data import data_loader as tdl
from fedml_tpu_torch.models import model_hub as thub
from fedml_tpu_torch.models.convert import from_flax_params
from fedml_tpu_torch.runner import FedMLRunner

TOL = 1e-5
_RUNS = [0]


def _cfg(**train):
    _RUNS[0] += 1
    cfg = {
        "common_args": {"training_type": "cross_silo", "random_seed": 0,
                        "run_id": f"torch_cs_{_RUNS[0]}"},
        "data_args": {"dataset": "synthetic", "train_size": 400, "test_size": 100,
                      "class_num": 5, "feature_dim": 16},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": 3, "epochs": 1,
                       "batch_size": 32, "learning_rate": 0.3},
    }
    comm = train.pop("comm", None)
    cfg["train_args"].update(train)
    if comm:
        cfg["comm_args"] = comm
    return cfg


class Fed:
    """One federation's ranks and what the test records: each round's test
    metrics and silo draw, and the global parameters after each round."""

    def __init__(self, server, clients, jax_side):
        self.server, self.clients, self.jax = server, clients, jax_side
        self.metrics, self.silos, self.globals = [], [], []
        agg = server.fedml_aggregator
        test, select = agg.test_on_server_for_all_clients, agg.data_silo_selection

        def recorded_test(r):
            m = test(r)
            self.metrics.append({k: float(m[k]) for k in ("test_loss", "test_acc")})
            self.globals.append(self.params())
            return m

        def recorded_select(*a):
            out = select(*a)
            self.silos.append(list(out))
            return out

        agg.test_on_server_for_all_clients = recorded_test
        agg.data_silo_selection = recorded_select
        self.initial = self.params()

    @property
    def managers(self):
        return [self.server.manager] + [c.manager for c in self.clients]

    def params(self):
        p = self.server.fedml_aggregator.get_global_model_params()
        if self.jax:
            return from_flax_params(jax.tree.map(np.asarray, p))
        return {k: v.detach().cpu().clone() for k, v in p.items()}


def _jax_fed(cfg):
    args = fedml_tpu.init(jarguments.load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = jdl.load_federated(args)
    model = jhub.create(args, ds.class_num)
    server = JServer(args, None, ds, model)
    clients = []
    for rank in range(1, int(args.client_num_per_round) + 1):
        cargs = copy.copy(args)
        cargs.rank = rank
        clients.append(JClient(cargs, None, ds, model))
    return Fed(server, clients, jax_side=True)


def _port_fed(cfg, init_from):
    args = targuments.load_arguments_from_dict(copy.deepcopy(cfg))
    ds = tdl.load_federated(args)
    model = thub.create(args, ds.class_num)
    server, clients = build_cross_silo_inproc(args, ds, model, "cpu")
    server.fedml_aggregator.set_global_model_params(
        from_flax_params(jax.tree.map(np.asarray, init_from)))
    return Fed(server, clients, jax_side=False)


def _jax_init(fed):
    return fed.server.fedml_aggregator.get_global_model_params()


def _run_local(fed, timeout=120.0):
    run_id = str(fed.server.args.run_id)
    msg = JMyMessage if fed.jax else MyMessage
    runner = jrun if fed.jax else run_managers_to_completion
    return runner(fed.managers, run_id, msg.MSG_TYPE_CONNECTION_IS_READY, timeout)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


def _hold(port, ref, codec):
    """Round by round: the same silos, the test metrics, and the global
    parameters — within TOL uncompressed, within one quantization step of
    each leaf (its largest round-to-round move / 127 for int8, the move
    itself for topk, whose dropped entries error feedback re-sends)."""
    assert port.silos == ref.silos
    assert len(port.metrics) == len(ref.metrics) == len(port.globals)
    steps, prev = {}, port.initial
    for r, (pm, rm, pg, rg) in enumerate(zip(port.metrics, ref.metrics, port.globals,
                                             ref.globals)):
        if codec is None:
            for k in pm:
                _close(pm[k], rm[k], TOL, f"round {r} {k}")
            for k in rg:
                _close(pg[k], rg[k], TOL, f"round {r} {k}")
            continue
        for k, v in pg.items():
            move = float((v - prev[k]).abs().max())
            steps[k] = max(steps.get(k, 0.0), move / 127 if codec == "int8" else move)
        for k in rg:
            err = float((pg[k] - rg[k]).abs().max())
            assert err <= max(steps[k], 1e-6), (r, k, err, steps[k])
        for k in pm:
            assert abs(pm[k] - rm[k]) <= 1e-2, (r, k, pm[k], rm[k])
        prev = pg


@pytest.mark.parametrize("codec", [None, "int8", "topk"])
@pytest.mark.parametrize("participation", ["full", "partial"])
def test_inproc_federation_matches_reference(participation, codec):
    train = {} if participation == "full" else {
        "client_num_in_total": 6, "client_num_per_round": 2, "comm_round": 3}
    if codec:
        train.update(compression=codec, compression_topk_ratio=0.3)
    cfg = _cfg(**train)
    ref = _jax_fed(cfg)
    port = _port_fed(cfg, _jax_init(ref))
    ref_result, port_result = _run_local(ref), _run_local(port)
    assert port_result["rounds"] == ref_result["rounds"] == 3
    if participation == "partial":
        assert len({tuple(s) for s in port.silos}) > 1  # other silos each round
    _hold(port, ref, codec)


def _broker_cfg(host, port, store, codec):
    return _cfg(**({"compression": codec} if codec else {}), comm={
        "comm_backend": "BROKER", "broker_host": host, "broker_port": port,
        "object_store_dir": store, "payload_offload_bytes": 64})


def _run_threads(managers, timeout=120.0):
    threads = [threading.Thread(target=m.run, daemon=True) for m in managers]
    for t in threads:
        t.start()
    end = time.monotonic() + timeout
    for t in threads:
        t.join(max(0.0, end - time.monotonic()))
    alive = [t.is_alive() for t in threads]
    errors = [m.handler_error for m in managers if m.handler_error is not None]
    if any(alive) or errors:
        for m in managers:
            m.finish()
    assert not errors, errors
    assert not any(alive), "the federation did not finish"


@pytest.mark.parametrize("codec", [None, "int8"])
@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_mixed_federation_over_the_broker_matches_all_jax(server_side, codec, tmp_path):
    """One federation, two frameworks, bytes on a TCP broker: the server of
    one package aggregates the uploads of the other's clients."""
    ref = _jax_fed(_cfg(**({"compression": codec} if codec else {})))
    init = _jax_init(ref)  # the reference's initial weights (immutable)
    assert _run_local(ref)["rounds"] == 3
    broker = (JBroker if server_side == "port" else PubSubBroker)().start()
    try:
        host, bport = broker.address
        cfg = _broker_cfg(host, bport, str(tmp_path), codec)
        jargs = fedml_tpu.init(jarguments.load_arguments_from_dict(copy.deepcopy(cfg)))
        targs = targuments.load_arguments_from_dict(copy.deepcopy(cfg))
        jds, tds = jdl.load_federated(jargs), tdl.load_federated(targs)
        jm, tm = jhub.create(jargs, jds.class_num), thub.create(targs, tds.class_num)
        if server_side == "jax":
            server = JServer(jargs, None, jds, jm)
        else:
            server = Server(targs, "cpu", tds, tm)
            server.fedml_aggregator.set_global_model_params(
                from_flax_params(jax.tree.map(np.asarray, init)))
        clients = []
        for rank in (1, 2, 3):
            if server_side == "jax":
                a = copy.copy(targs)
                a.rank = rank
                clients.append(Client(a, "cpu", tds, tm))
            else:
                a = copy.copy(jargs)
                a.rank = rank
                clients.append(JClient(a, None, jds, jm))
        fed = Fed(server, clients, jax_side=server_side == "jax")
        _run_threads(fed.managers)
    finally:
        broker.stop()
    assert fed.server.manager.result["rounds"] == 3
    _hold(fed, ref, codec)


class _Stall:
    """Client 3's round-0 training waits until the server has closed round
    0 at quorum (its upload then arrives stale, which readmits it); clients
    1 and 2 wait in round 1 until client 3 has been re-synced, so the rejoin
    lands inside round 1 on both packages."""

    def __init__(self, fed, timeout=60.0):
        self.fed, self.timeout = fed, timeout
        self.rejoined = threading.Event()
        self.residual_after_rejoin = "unset"
        for c in fed.clients:
            mgr = c.manager
            trainer = mgr.trainer_dist_adapter.trainer
            trainer.run_local_training = self._gated(mgr, trainer.run_local_training)
        mgr3 = fed.clients[2].manager
        rejoin = mgr3.handle_message_rejoin_sync

        def recorded_rejoin(msg):
            rejoin(msg)
            self.residual_after_rejoin = mgr3._error_feedback.residual
            self.rejoined.set()

        # an instance attribute: the handler table is built from it at start
        mgr3.handle_message_rejoin_sync = recorded_rejoin
        self.missing = []
        finish_round = fed.server.manager._finish_round

        def recorded_finish(missing):
            self.missing.append(list(missing))
            return finish_round(missing)

        fed.server.manager._finish_round = recorded_finish

    def _wait(self, cond, what):
        end = time.monotonic() + self.timeout
        while not cond():
            if time.monotonic() > end:
                raise TimeoutError(what)
            time.sleep(0.01)

    def _gated(self, mgr, run):
        def wrapped(*a, **kw):
            if mgr.rank == 3 and mgr.round_idx == 0:
                self._wait(lambda: self.fed.server.manager.args.round_idx >= 1,
                           "round 0 never closed at quorum")
            if mgr.rank in (1, 2) and mgr.round_idx == 1:
                self._wait(self.rejoined.is_set, "client 3 never rejoined")
            return run(*a, **kw)

        return wrapped


def test_deadline_quorum_and_rejoin_match_reference():
    """Round 0 closes at quorum after its deadline with silo 3 stalled:
    missing [3], and the aggregate of silos 1 and 2 is the reference's.
    Silo 3's stale upload readmits it, its error feedback resets on the
    rejoin, and it trains again in round 2."""
    cfg = _cfg(compression="int8", round_deadline_s=1.0, round_quorum=0.66)
    ref = _jax_fed(cfg)
    port = _port_fed(cfg, _jax_init(ref))
    stalls = [_Stall(ref), _Stall(port)]
    assert _run_local(ref)["rounds"] == _run_local(port)["rounds"] == 3
    for s in stalls:
        assert s.missing == [[3], [], []], s.missing
        assert s.residual_after_rejoin is None
        assert s.fed.server.manager.liveness.evicted() == []
    assert port.silos == ref.silos
    _hold(port, ref, "int8")


def test_below_quorum_round_aborts_loudly():
    """A round that never reaches quorum re-arms its deadline a bounded
    number of times, then fails the federation through ``handler_error``."""
    cfg = _cfg(round_deadline_s=30.0, round_quorum=2 / 3, round_deadline_extensions=2)
    port = _port_fed(cfg, _jax_init(_jax_fed(cfg)))
    mgr = port.server.manager
    mgr.is_initialized = True
    mgr.client_id_list_in_this_round = [1, 2, 3]
    mgr.args.round_idx = 1
    mgr.aggregator.add_local_trained_result(0, mgr.aggregator.get_global_model_params(), 10)
    for _ in range(2):
        mgr._on_round_deadline(1)
        assert mgr.handler_error is None
        mgr._deadline.cancel()
    mgr._on_round_deadline(1)
    assert isinstance(mgr.handler_error, RuntimeError)
    assert "below quorum" in str(mgr.handler_error)


def test_stale_upload_is_dropped_and_readmits_an_evicted_sender():
    cfg = _cfg()
    port = _port_fed(cfg, _jax_init(_jax_fed(cfg)))
    mgr = port.server.manager
    mgr.is_initialized = True
    mgr.client_id_list_in_this_round = [1, 2, 3]
    mgr._round_closed = True
    from fedml_tpu_torch.core.distributed.message import Message
    from fedml_tpu_torch.models.convert import to_wire_params

    stale = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 2, 0)
    stale.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS,
                     to_wire_params(mgr.aggregator.get_global_model_params()))
    stale.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, 10)
    stale.add_params(MyMessage.MSG_ARG_KEY_ROUND, 0)
    mgr.liveness.evict(2)
    sent = []
    mgr.com_manager.send_message = sent.append
    mgr.handle_message_receive_model_from_client(stale)
    assert mgr.aggregator.n_received() == 0
    assert not mgr.liveness.is_evicted(2)
    assert [m.get_type() for m in sent] == [MyMessage.MSG_TYPE_S2C_REJOIN_SYNC]
    assert sent[0].get("rejoin") is True and sent[0].get(MyMessage.MSG_ARG_KEY_ROUND) == 0


REFUSALS = {
    "secure aggregation": ({"secure_aggregation": True}, 0, r"A10\.2"),
    "integrity": ({"integrity": True}, 0, r"A10\.2"),
    "agg_robust": ({"agg_robust": "median"}, 0, r"A10\.2"),
    "defense": ({"enable_defense": True, "defense_type": "krum"}, 0, r"A10\.2"),
    "differential privacy": ({"enable_dp": True}, 1, r"A10\.2"),
    "async server": ({"async_aggregation": True}, 0, r"A10\.3"),
    "AsyncFedAvg": ({"federated_optimizer": "AsyncFedAvg"}, 0, r"A10\.3"),
    "hierarchical scenario": ({"scenario": "hierarchical"}, 0, r"A10\.3"),
    "chaos": ({"chaos": {"drop": 0.1}}, 1, r"A10\.3"),
    "durability journal": ({"durability": True}, 0, r"A10\.3"),
    "GRPC": ({"comm_backend": "GRPC"}, 0, r"A10\.4"),
    "TRPC": ({"comm_backend": "TRPC"}, 1, r"A10\.4"),
    "MQTT_S3": ({"comm_backend": "MQTT_S3"}, 0, r"A10\.4"),
    "cross-cloud": ({"training_type": "cross_cloud"}, 0, r"A10\.4"),
    "resume": ({"resume": True}, 0, r"A4"),
    "checkpoint_dir": ({"checkpoint_dir": "/nowhere"}, 0, r"A4"),
    "live telemetry": ({"live_telemetry": True}, 1, r"A12"),
    "n_proc_in_silo": ({"n_proc_in_silo": 2}, 1, r"A11"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unported_options_raise_naming_their_item(case):
    over, rank, item = REFUSALS[case]
    args = targuments.load_arguments_from_dict(_cfg())
    for k, v in over.items():
        setattr(args, k, v)
    args.rank = rank
    ds = tdl.load_federated(args)
    with pytest.raises(NotImplementedError, match=item):
        FedMLRunner(args, "cpu", ds, thub.create(args, ds.class_num))


def test_runner_builds_the_cross_silo_roles():
    args = targuments.load_arguments_from_dict(_cfg())
    ds = tdl.load_federated(args)
    model = thub.create(args, ds.class_num)
    server = FedMLRunner(args, "cpu", ds, model).runner
    args_c = copy.copy(args)
    args_c.rank, args_c.role = 2, "client"
    client = FedMLRunner(args_c, "cpu", ds, model).runner
    assert isinstance(server, Server) and isinstance(client, Client)
    assert client.manager.rank == 2 and server.manager.client_num == 3


def test_entry_points_run_a_broker_federation_on_the_cpu(tmp_path):
    """``run_cross_silo_server`` and ``run_cross_silo_client`` (what
    ``--cf config --rank r --role ...`` starts) on one broker, on the CPU;
    without ``device="cpu"`` they refuse a machine with no CUDA."""
    broker = PubSubBroker().start()
    try:
        host, port = broker.address
        cfg = _broker_cfg(host, port, str(tmp_path), "int8")
        out = {}

        def run(role, rank):
            args = targuments.load_arguments_from_dict(copy.deepcopy(cfg))
            args.rank = rank
            fn = (fedml_tpu_torch.run_cross_silo_server if role == "server"
                  else fedml_tpu_torch.run_cross_silo_client)
            out[rank] = fn(args, device="cpu")

        threads = [threading.Thread(target=run, args=("server", 0), daemon=True)] + [
            threading.Thread(target=run, args=("client", r), daemon=True) for r in (1, 2, 3)]
        for t in threads:
            t.start()
        end = time.monotonic() + 120
        for t in threads:
            t.join(max(0.0, end - time.monotonic()))
        assert not any(t.is_alive() for t in threads)
    finally:
        broker.stop()
    assert out[0]["rounds"] == 3 and np.isfinite(out[0]["test_loss"])
    assert [out[r] for r in (1, 2, 3)] == [None] * 3
    if not torch.cuda.is_available():
        args = targuments.load_arguments_from_dict(_cfg())
        for fn in (fedml_tpu_torch.run_cross_silo_server,
                   fedml_tpu_torch.run_cross_silo_client):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                fn(args)


@pytest.mark.parametrize("store", ["local", "cas"])
def test_offload_goes_through_the_store(store, tmp_path):
    """A payload above ``payload_offload_bytes`` rides the object store: the
    frames carry only its key and each receiver gets the tensors back. The
    shared directory deletes a blob once fetched; the content-addressed
    store keeps one blob for a broadcast's identical payloads (a receiver
    never deletes: a sibling may still fetch it)."""
    from fedml_tpu_torch.core.distributed.communication.broker_comm import BrokerCommManager
    from fedml_tpu_torch.core.distributed.communication.object_store import (
        create_object_store,
    )
    from fedml_tpu_torch.core.distributed.message import Message
    from fedml_tpu_torch.telemetry import get_registry

    broker = PubSubBroker().start()
    store = create_object_store(types.SimpleNamespace(remote_storage=store,
                                                      object_store_dir=str(tmp_path)))
    host, port = broker.address
    reg = get_registry()
    before = reg.counter("comm/offload_wire_bytes").value
    big = {"params": {"w": torch.arange(4096, dtype=torch.float32)}}
    try:
        tx = BrokerCommManager("off", 0, host, port, store, offload_bytes=1024)
        rxs = [BrokerCommManager("off", r, host, port, store, offload_bytes=1024)
               for r in (1, 2)]
        got = []

        class Obs:
            def __init__(self, rx):
                self.rx = rx

            def receive_message(self, t, m):
                got.append(m)
                self.rx.stop_receive_message()

        for rx in rxs:
            rx.add_observer(Obs(rx))
        for r in (1, 2):
            tx.send_message(Message("M", 0, r).add_params("model_params", big))
        for rx in rxs:
            rx.handle_receive_message()
        tx.stop_receive_message()
    finally:
        broker.stop()
    assert len(got) == 2
    for m in got:
        assert torch.equal(m.get("model_params")["params"]["w"], big["params"]["w"])
    assert reg.counter("comm/offload_wire_bytes").value - before > 2 * 4096 * 4
    blobs = [p for p in tmp_path.rglob("*") if p.is_file()]
    assert len(blobs) == (0 if store.content_addressed is False else 1)
