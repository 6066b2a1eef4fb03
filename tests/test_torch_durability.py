"""The port's write-ahead round journal and its replay against the
reference's (``tests/test_durability.py`` mirrored, on the CPU):

* the journal both ways: for the same records (plain, int8 and identity
  payloads) the port writes the reference's journal bytes exactly, each
  package parses the other's file to the same records and ``salvage_round``
  result; the round trip, torn-tail truncation and CRC corruption carry over;
* the sync server: a mid-round salvage across a restart (only the missing
  cohort is re-broadcast, the dedup primed), a closed round that replays and
  re-aggregates (parameters within the cross-silo tests' 1e-5 of the JAX
  run's), the refused ``kill_server`` without durability, and a secagg round
  that is not resumed;
* the async server's durable FedBuff buffer: refill across a restart, the
  flush marker against the checkpoint (the re-flush equals the flush bit for
  bit, and the JAX run's within 1e-5), and instant-apply version checkpoints;
* the cross-process acceptance: ``run_recover_scenario`` SIGKILLs a real
  server process mid-round over the broker and respawns it; with the identity
  codec its final digest equals an uninterrupted in-process run bit for bit,
  with int8 it completes and salvages.
"""
import copy
import os

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import arguments as jarguments
from fedml_tpu.compression import codecs as jc
from fedml_tpu.core.distributed.message import Message as JMessage
from fedml_tpu.resilience.durability import journal as jj
from fedml_tpu.utils import serialization as jser
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch.core.checkpoint import RoundCheckpointer
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.cross_silo.server.server import Server
from fedml_tpu_torch.data import data_loader as tdl
from fedml_tpu_torch.models import model_hub as thub
from fedml_tpu_torch.models.convert import from_flax_params, to_wire_params
from fedml_tpu_torch.resilience.durability import (
    RoundJournal,
    journal as tj,
    salvage_round,
)
from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils import serialization as tser

TOL = 1e-5  # the cross-silo parity tests' bound (tests/test_torch_cross_silo.py)


def _counter(name):
    return get_registry().counter(name).value


def _as_np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _same_value(a, b):
    """A port record value against a reference one: tensors against arrays,
    compressed trees part by part, containers by key."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(map(str, a)) == sorted(map(str, b))
        for k in a:
            _same_value(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_value(x, y)
    elif hasattr(a, "arrays") and hasattr(a, "codec"):
        assert (a.codec, a.version, a.is_delta, a.meta) == (b.codec, b.version, b.is_delta,
                                                           b.meta)
        for pa, pb in zip(a.arrays, b.arrays):
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(_as_np(x), _as_np(y))
    elif isinstance(a, (torch.Tensor, np.ndarray)) or hasattr(b, "shape"):
        np.testing.assert_array_equal(_as_np(a), _as_np(b))
    else:
        assert a == b, (a, b)


# -- journal units ---------------------------------------------------------------

def test_journal_roundtrip_fsync_and_payload_fidelity(tmp_path):
    j = RoundJournal(str(tmp_path / "r.journal"))
    payload = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
               "b": torch.ones(4)}
    before = _counter("resilience/journal_records")
    j.append("round_open", round=2, cohort=[1, 2, 3], silo_index={1: 0, 2: 1, 3: 2},
             seed=7, codec="int8", secagg=False)
    j.append("upload_received", round=2, client=2, msg_id="m:2:9", n_samples=40,
             local_steps=None, payload=payload)
    j.close()
    recs = RoundJournal(str(tmp_path / "r.journal")).records()  # the restarted process
    assert [r["kind"] for r in recs] == ["round_open", "upload_received"]
    assert recs[0]["cohort"] == [1, 2, 3]
    assert recs[0]["silo_index"] == {1: 0, 2: 1, 3: 2}
    assert torch.equal(recs[1]["payload"]["w"], payload["w"])
    assert recs[1]["msg_id"] == "m:2:9"
    assert _counter("resilience/journal_records") == before + 2
    j2 = RoundJournal(str(tmp_path / "r.journal"))
    j2.reset()
    assert j2.records() == [] and j2.nbytes == 0


def test_journal_torn_tail_truncates_at_last_valid_record(tmp_path):
    path = str(tmp_path / "torn.journal")
    j = RoundJournal(path)
    for i in range(3):
        j.append("upload_received", round=0, client=i, payload=None)
    j.close()
    good_size = os.path.getsize(path)
    with open(path, "ab") as f:  # a half-written frame: the crash artifact
        f.write(b"RJ\x40\x00\x00\x00\x12\x34")
    before = _counter("resilience/journal_truncations")
    j2 = RoundJournal(path)
    assert [int(r["client"]) for r in j2.records()] == [0, 1, 2]
    assert _counter("resilience/journal_truncations") == before + 1
    assert os.path.getsize(path) == good_size
    j2.append("upload_received", round=0, client=9, payload=None)
    assert [int(r["client"]) for r in j2.records()] == [0, 1, 2, 9]


def test_journal_crc_corruption_drops_from_bad_record_on(tmp_path):
    path = str(tmp_path / "crc.journal")
    j = RoundJournal(path)
    offsets = []
    for i in range(3):
        offsets.append(os.path.getsize(path))
        j.append("upload_received", round=0, client=i, payload=None)
    j.close()
    with open(path, "r+b") as f:
        f.seek(offsets[1] + 10 + 12)
        orig = f.read(1)
        f.seek(offsets[1] + 10 + 12)
        f.write(bytes([orig[0] ^ 0xFF]))
    assert [int(r["client"]) for r in RoundJournal(path).records()] == [0]


SALVAGE_RECORDS = [
    {"kind": "round_open", "round": 1, "cohort": [1, 2], "silo_index": {1: 0, 2: 1},
     "secagg": False},
    {"kind": "upload_received", "round": 1, "client": 1, "msg_id": "a", "n_samples": 10},
    {"kind": "upload_received", "round": 1, "client": 2, "msg_id": "b", "n_samples": 20},
    {"kind": "quorum_close", "round": 1, "missing": []},
    {"kind": "aggregate_committed", "round": 1},
    {"kind": "round_open", "round": 2, "cohort": [1, 2], "silo_index": {1: 0, 2: 1},
     "secagg": False},
    {"kind": "upload_received", "round": 2, "client": 2, "msg_id": "c", "n_samples": 20},
]


def _salvage_fields(sal):
    if sal is None:
        return None
    return (sal.round_idx, sal.cohort, sal.silo_index, sal.uploaded_clients, sal.closed,
            sal.missing, sal.secagg)


@pytest.mark.parametrize("records,expected", [
    (SALVAGE_RECORDS, 2),
    (SALVAGE_RECORDS[:5], 2),                 # only committed rounds
    (SALVAGE_RECORDS, 3),                     # the checkpoint is ahead: stale
    (SALVAGE_RECORDS + [{"kind": "quorum_close", "round": 2, "missing": [0]}], 2),
    (SALVAGE_RECORDS + [{"kind": "round_rolled_back", "round": 2}], 2),
])
def test_salvage_round_replay_logic_matches_reference(records, expected):
    got = _salvage_fields(salvage_round(records, expected_round=expected))
    assert got == _salvage_fields(jj.salvage_round(records, expected_round=expected))
    if records is SALVAGE_RECORDS and expected == 2:
        assert got == (2, [1, 2], {1: 0, 2: 1}, [2], False, [], False)
    if len(records) == len(SALVAGE_RECORDS) + 1 and records[-1]["kind"] == "quorum_close":
        assert got[4] is True and got[5] == [0]


# -- the journal both ways ---------------------------------------------------------

def _journal_records(kind, port):
    """One round's records with a payload of ``kind``, as the reference's
    objects (``port=False``) or the port's (the same content)."""
    rng = np.random.default_rng(3)
    plain = {"params": {"Dense_0": {"kernel": rng.standard_normal((5, 3)).astype(np.float32),
                                    "bias": rng.standard_normal(3).astype(np.float32)}}}
    payload = None
    if kind == "plain":
        payload = plain
    elif kind in ("int8", "identity"):
        payload = jc.get_codec(kind).encode(jax.tree.map(jax.numpy.asarray, plain),
                                            key=jc.derive_key(0, 1, 2), is_delta=True)
    if port and payload is not None:
        # the same content as the port's objects: through the shared wire
        payload = tser.safe_loads(jser.safe_dumps(payload))
    return [
        ("round_open", dict(round=1, cohort=[1, 2, 3], silo_index={1: 4, 2: 0, 3: 7},
                            seed=5, codec=None if kind == "plain" else kind, secagg=False)),
        ("upload_received", dict(round=1, client=3, msg_id="abc:3:4", n_samples=40,
                                 local_steps=2.0, payload=payload)),
        ("quorum_close", dict(round=1, missing=[1])),
    ]


@pytest.mark.parametrize("kind", ["plain", "int8", "identity", "none"])
def test_journal_bytes_and_records_match_reference_both_ways(kind, tmp_path):
    jpath, tpath = str(tmp_path / "jax.journal"), str(tmp_path / "port.journal")
    jjournal, tjournal = jj.RoundJournal(jpath), RoundJournal(tpath)
    for (rk, jfields), (_, tfields) in zip(_journal_records(kind, False),
                                           _journal_records(kind, True)):
        jjournal.append(rk, durable=rk != "quorum_close", **jfields)
        tjournal.append(rk, durable=rk != "quorum_close", **tfields)
    jjournal.close()
    tjournal.close()
    jbytes, tbytes = open(jpath, "rb").read(), open(tpath, "rb").read()
    assert tbytes == jbytes  # the reference's frames and payloads, byte for byte
    # each reads the other's file to the same records and salvage
    t_of_j, end_tj = tj.parse_frames(jbytes)
    j_of_t, end_jt = jj.parse_frames(tbytes)
    assert end_tj == end_jt == len(jbytes)
    assert len(t_of_j) == len(j_of_t) == 3
    for a, b in zip(t_of_j, j_of_t):
        _same_value(a, b)
    sal_t, sal_j = salvage_round(t_of_j, 1), jj.salvage_round(j_of_t, 1)
    assert _salvage_fields(sal_t) == _salvage_fields(sal_j) == (
        1, [1, 2, 3], {1: 4, 2: 0, 3: 7}, [3], True, [1], False)
    _same_value(sal_t.uploads[0]["payload"], sal_j.uploads[0]["payload"])


# -- the sync server: mid-round salvage and replay ------------------------------------

def _cs_cfg(run_id, tmp, rounds=3, extra=None):
    return {
        "common_args": {"training_type": "cross_silo", "random_seed": 0,
                        "run_id": run_id, "log_file_dir": str(tmp)},
        "data_args": {"dataset": "synthetic", "train_size": 240, "test_size": 60,
                      "class_num": 4, "feature_dim": 12},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": rounds, "epochs": 1,
                       "batch_size": 32, "learning_rate": 0.3, "durability": True,
                       "resume": True,
                       "checkpoint_dir": os.path.join(str(tmp), "ckpts"),
                       **(extra or {})},
    }


def _port_server(cfg):
    args = fedml_tpu_torch.init(targuments.load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = tdl.load_federated(args)
    return args, Server(args, "cpu", ds, thub.create(args, ds.class_num))


def _jax_server(cfg):
    from fedml_tpu import models as jmodels
    from fedml_tpu.cross_silo.server.server import Server as JServer
    from fedml_tpu.data import load_federated

    args = fedml_tpu.init(jarguments.load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = load_federated(args)
    return args, JServer(args, None, ds, jmodels.create(args, ds.class_num))


def _upload_msg(mgr, sender, round_idx, msg_id, value=1.0):
    params = {k: torch.full_like(v, value)
              for k, v in mgr.aggregator.get_global_model_params().items()}
    m = Message("MSG_TYPE_C2S_SEND_MODEL_TO_SERVER", sender, 0)
    m.add_params("model_params", to_wire_params(params))
    m.add_params("num_samples", 40)
    m.add_params("round", round_idx)
    m.add_params(Message.MSG_ARG_KEY_MSG_ID, msg_id)
    return m


def _jax_upload_msg(mgr, sender, round_idx, msg_id, value=1.0):
    params = jax.tree.map(lambda x: np.full(np.shape(x), value, np.float32),
                          mgr.aggregator.get_global_model_params())
    m = JMessage("MSG_TYPE_C2S_SEND_MODEL_TO_SERVER", sender, 0)
    m.add_params("model_params", params)
    m.add_params("num_samples", 40)
    m.add_params("round", round_idx)
    m.add_params(JMessage.MSG_ARG_KEY_MSG_ID, msg_id)
    return m


def _params(server, jax_side=False):
    p = server.manager.aggregator.get_global_model_params()
    if jax_side:
        return from_flax_params(jax.tree.map(np.asarray, p))
    return {k: v.detach().clone() for k, v in p.items()}


def _hold_params(port, ref):
    assert list(port) == list(ref)
    for k in ref:
        err = float((port[k] - ref[k]).abs().max())
        assert err <= TOL * max(1.0, float(ref[k].abs().max())), (k, err)


def test_server_salvages_mid_round_uploads_across_restart(tmp_path):
    """Killed between uploads 1 and 2: the restarted manager puts the
    journaled upload back, primes the dedup, and re-broadcasts only to the
    clients whose uploads died with the old process."""
    _, server = _port_server(_cs_cfg("tdur_salv", tmp_path))
    mgr = server.manager
    mgr.is_initialized = True
    mgr._select_round_clients()
    mgr._journal_round_open()
    mgr.handle_message_receive_model_from_client(_upload_msg(mgr, 2, 0, "old:2:1"))
    assert mgr.aggregator.n_received() == 1
    before = _counter("resilience/restarts")
    _, server2 = _port_server(_cs_cfg("tdur_salv_r2", tmp_path))
    mgr2 = server2.manager
    assert _counter("resilience/restarts") == before + 1
    sal = mgr2._salvaged
    assert sal is not None and sal.round_idx == 0 and sal.uploaded_clients == [2]
    sent = []
    mgr2.send_message = sent.append
    mgr2.is_initialized = True
    salvaged = _counter("resilience/journal_salvaged")
    mgr2._resume_salvaged_round()
    assert _counter("resilience/journal_salvaged") == salvaged + 1
    assert mgr2.aggregator.n_received() == 1
    assert mgr2.client_id_list_in_this_round == sal.cohort
    assert sorted(m.get_receiver_id() for m in sent) == [c for c in sal.cohort if c != 2]
    assert all(m.get_type() == "MSG_TYPE_S2C_INIT_CONFIG" for m in sent)
    assert mgr2._deduper.seen("old:2:1")
    mgr2._deadline.cancel()
    mgr.finish()
    mgr2.finish()


def test_server_closed_round_replays_and_reaggregates(tmp_path):
    """A crash after the last upload (closed, never committed): the replay
    closes at once and re-aggregates, no broadcast of the old round leaves,
    and the aggregate is the JAX server's under the same replay."""
    results = {}
    for side in ("jax", "port"):
        tmp = tmp_path / side
        cfg, cfg2 = _cs_cfg(f"dur_closed_{side}", tmp), _cs_cfg(f"dur_closed_{side}_r2", tmp)
        build, upload = ((_jax_server, _jax_upload_msg) if side == "jax"
                         else (_port_server, _upload_msg))
        _, server = build(cfg)
        mgr = server.manager
        mgr.is_initialized = True
        mgr._select_round_clients()
        mgr._journal_round_open()
        hit = []
        mgr._complete_round = lambda: hit.append(1)  # the crash before the aggregate
        for c in (1, 2, 3):
            mgr.handle_message_receive_model_from_client(
                upload(mgr, c, 0, f"old:{c}:1", value=float(c)))
        assert hit == [1]
        args2, server2 = build(cfg2)
        mgr2 = server2.manager
        assert sorted(mgr2._salvaged.uploaded_clients) == [1, 2, 3]
        sent = []
        mgr2.send_message = sent.append
        mgr2.is_initialized = True
        mgr2._resume_salvaged_round()
        assert args2.round_idx == 1
        assert all(int(m.get("round")) == 1 for m in sent
                   if m.get_type() == "MSG_TYPE_S2C_SYNC_MODEL_TO_CLIENT")
        assert not any(m.get_type() == "MSG_TYPE_S2C_INIT_CONFIG" for m in sent)
        if side == "port":
            assert RoundCheckpointer(os.path.join(str(tmp), "ckpts")).latest_round() == 0
        assert [(r["kind"], r["round"]) for r in mgr2._journal.records()] == [
            ("round_open", 1)]
        results[side] = _params(server2, jax_side=side == "jax")
        mgr2._deadline.cancel()
        mgr.finish()
        mgr2.finish()
    _hold_params(results["port"], results["jax"])


def test_kill_server_chaos_without_durability_is_refused(tmp_path):
    cfg = _cs_cfg("tdur_guard", tmp_path)
    cfg["train_args"].pop("durability")
    cfg["train_args"]["chaos"] = {"kill_server": {"round": 1}}
    with pytest.raises(ValueError, match="durability"):
        _port_server(cfg)


def test_secagg_round_is_not_resumed_mid_round(tmp_path):
    """A journaled masked round aborts to the round boundary: the masks died
    with the session, so the salvage is dropped loudly (the counter; the
    reference's health event waits for the port's telemetry, ROADMAP A12)."""
    ckpt_dir = os.path.join(str(tmp_path), "ckpts")
    j = RoundJournal(os.path.join(ckpt_dir, "server_round.journal"))
    j.append("round_open", round=0, cohort=[1, 2, 3], silo_index={1: 0, 2: 1, 3: 2},
             seed=0, codec=None, secagg=True)
    j.append("upload_received", round=0, client=1, msg_id="m", n_samples=40,
             payload={"w": torch.zeros(4)})
    j.close()
    before = _counter("secagg/resume_aborts")
    _, server = _port_server(_cs_cfg("tdur_sa", tmp_path))
    mgr = server.manager
    assert mgr._salvaged is None
    assert _counter("secagg/resume_aborts") == before + 1
    assert mgr._journal.records() == []
    mgr.finish()


# -- the durable FedBuff buffer (async server) ----------------------------------------

def _async_cfg(run_id, tmp, extra=None):
    return _cs_cfg(run_id, tmp, extra={"async_aggregation": True, "async_buffer_size": 3,
                                       "async_total_updates": 6, **(extra or {})})


def test_async_fedbuff_buffer_survives_restart(tmp_path):
    _, server = _port_server(_async_cfg("tdur_async", tmp_path))
    mgr = server.manager
    assert mgr._buffer is not None and mgr._journal is not None
    mgr.send_message = lambda m: None
    for sender in (1, 2):  # 2 of 3: no flush yet
        mgr.handle_client_update(_upload_msg(mgr, sender, 0, f"a:{sender}",
                                             value=float(sender)))
    assert len(mgr._buffer) == 2 and mgr.flushes == 0
    _, server2 = _port_server(_async_cfg("tdur_async_r2", tmp_path))
    mgr2 = server2.manager
    assert len(mgr2._buffer) == 2 and mgr2.applied == 2
    assert sorted((e.sender, e.n_samples) for e in mgr2._buffer._entries) == [
        (1, 40.0), (2, 40.0)]
    mgr2.send_message = lambda m: None
    mgr2.handle_client_update(_upload_msg(mgr2, 3, 0, "a:3", value=3.0))
    assert mgr2.flushes == 1 and len(mgr2._buffer) == 0
    assert mgr2._journal.records() == []
    assert RoundCheckpointer(os.path.join(str(tmp_path), "ckpts")).latest_round() == 1
    mgr.finish()
    mgr2.finish()


def _flush_marker_run(side, tmp):
    """The reference's crash window "marker written, checkpoint lost": three
    uploads flush with the checkpoint and the reset disabled, then a restart
    must flush again to the same parameters. The uploads are constant models
    of 1, 2 and 3, so the flush lands on their mean from either package's
    initial model."""
    build, upload = ((_jax_server, _jax_upload_msg) if side == "jax"
                     else (_port_server, _upload_msg))
    _, server = build(_async_cfg(f"dur_async_m_{side}", tmp))
    mgr = server.manager
    mgr.send_message = lambda m: None
    mgr._ckpt = None
    real_reset = mgr._journal.reset
    mgr._journal.reset = lambda: None
    for sender in (1, 2, 3):
        mgr.handle_client_update(upload(mgr, sender, 0, f"b:{sender}", value=float(sender)))
    assert mgr.flushes == 1
    mgr._journal.reset = real_reset
    after_flush = _params(server, jax_side=side == "jax")
    _, server2 = build(_async_cfg(f"dur_async_m_{side}_r2", tmp))
    mgr2 = server2.manager
    assert mgr2.version == 1 and mgr2.flushes == 1  # flushed again
    refl = _params(server2, jax_side=side == "jax")
    for k in after_flush:
        assert torch.equal(refl[k], after_flush[k]), k
    assert mgr2._journal.records() == []
    mgr.finish()
    mgr2.finish()
    return refl


def test_async_flush_marker_vs_checkpoint_disambiguates(tmp_path):
    ref = _flush_marker_run("jax", tmp_path / "jax")
    port = _flush_marker_run("port", tmp_path / "port")
    _hold_params(port, ref)


def test_async_instant_apply_checkpoints_every_version(tmp_path):
    """Instant-apply durability: every applied version is a round
    checkpoint, so a restart resumes at the exact applied state; the state
    is the JAX server's within 1e-5."""
    results = {}
    for side in ("jax", "port"):
        tmp = tmp_path / side
        extra = {"async_aggregation": True}
        build, upload = ((_jax_server, _jax_upload_msg) if side == "jax"
                         else (_port_server, _upload_msg))
        _, server = build(_cs_cfg(f"dur_inst_{side}", tmp, extra=extra))
        mgr = server.manager
        if side == "port":
            mgr.aggregator.set_global_model_params(results["jax_init"])
            assert mgr._buffer is None and mgr._journal is None and mgr._instant_durable
        else:
            results["jax_init"] = _params(server, jax_side=True)
        mgr.send_message = lambda m: None
        for sender in (1, 2):
            mgr.handle_client_update(upload(mgr, sender, 0, f"i:{sender}",
                                            value=float(sender)))
        assert mgr.version == 2
        applied = _params(server, jax_side=side == "jax")
        _, server2 = build(_cs_cfg(f"dur_inst_{side}_r2", tmp, extra=extra))
        assert server2.manager.version == 2
        resumed = _params(server2, jax_side=side == "jax")
        for k in applied:
            assert torch.equal(resumed[k], applied[k]), k
        results[side] = resumed
        mgr.finish()
        server2.manager.finish()
    _hold_params(results["port"], results["jax"])


# -- the cross-process acceptance: SIGKILL the real server process ---------------------

def _inproc_digest(tmp, seed, rounds, clients, compression):
    """The uninterrupted run of the same config, in process over LOCAL."""
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.resilience.durability.recover import digest, scenario_config

    cfg = scenario_config("trecover_ref", seed, rounds, clients, "127.0.0.1", 1, str(tmp),
                          compression=compression, device="cpu")
    for k in ("comm_backend", "broker_host", "broker_port"):
        cfg["train_args"].pop(k)
    args = fedml_tpu_torch.init(targuments.load_arguments_from_dict(cfg))
    ds = tdl.load_federated(args)
    server, clients_ = build_cross_silo_inproc(args, ds, thub.create(args, ds.class_num),
                                               "cpu")
    run_managers_to_completion([server.manager] + [c.manager for c in clients_],
                               "trecover_ref", MyMessage.MSG_TYPE_CONNECTION_IS_READY, 120)
    return digest(server.manager.aggregator.get_global_model_params())


def test_server_sigkill_resume_bit_identical_cross_process(tmp_path):
    """A real server process is SIGKILLed mid-round over the broker, the
    supervisor respawns it with resume, the journal salvages the received
    upload (its client trains that round once), and the final parameters
    equal an uninterrupted in-process run bit for bit."""
    from fedml_tpu_torch.resilience.durability import run_recover_scenario

    killed = run_recover_scenario(seed=7, rounds=3, clients=2, kill=True, kill_round=1,
                                  compression="identity", timeout=180,
                                  tmp_dir=str(tmp_path / "kill"), device="cpu")
    assert killed["completed"], killed
    assert killed["restarts"] == 1
    assert killed["salvaged_uploads"] > 0 and killed["resumed_round"] == 1
    assert killed["mttr_s"] is not None and killed["mttr_s"] < 120
    for c in killed["salvaged_clients"]:
        assert killed["trained"][str(c)].count(killed["resumed_round"]) == 1, killed
    assert killed["digest"] == _inproc_digest(tmp_path / "ref", 7, 3, 2, "identity")


def test_server_sigkill_int8_acceptance(tmp_path):
    """int8 uplinks: the killed and respawned federation finishes every
    round and salvages its journaled upload (a lossy codec resumes to an
    equivalent result, not an equal one)."""
    from fedml_tpu_torch.resilience.durability import run_recover_scenario

    out = run_recover_scenario(seed=11, rounds=3, clients=2, kill=True, kill_round=1,
                               compression="int8", timeout=180,
                               tmp_dir=str(tmp_path / "i8"), device="cpu")
    assert out["completed"], out
    assert out["restarts"] == 1 and out["salvaged_uploads"] > 0
    assert out["result"]["rounds"] == 3
    for c in out["salvaged_clients"]:
        assert out["trained"][str(c)].count(out["resumed_round"]) == 1


def test_fp32_precision_is_shared_by_concurrent_trainers():
    """The in-process federations train silos on threads of one process, and
    the TF32 flags are process-wide: the first trainer to enter turns TF32
    off and the last to leave restores it, so no silo's steps run with TF32
    while another finishes (which broke a card run's bit-identity with the
    same federation as processes). The flags need no card to be set."""
    import threading

    from fedml_tpu_torch.ml.trainer.local_sgd import fp32_precision

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    seen = []
    a_in, b_in, a_out = threading.Event(), threading.Event(), threading.Event()

    def trainer_a():
        with fp32_precision(torch.device("cuda")):
            a_in.set()
            b_in.wait(5)
        a_out.set()

    def trainer_b():
        a_in.wait(5)
        with fp32_precision(torch.device("cuda")):
            b_in.set()
            a_out.wait(5)  # A has left; B is still training
            seen.append((torch.backends.cudnn.allow_tf32,
                         torch.backends.cuda.matmul.allow_tf32))

    try:
        threads = [threading.Thread(target=t) for t in (trainer_a, trainer_b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert seen == [(False, False)]
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
            True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def test_fp32_precision_under_a_thread_storm():
    """More trainers than cores entering and leaving at random with a short
    switch interval: TF32 is off whenever one is inside, and the flags come
    back once all have left."""
    import random
    import sys
    import threading

    from fedml_tpu_torch.ml.trainer.local_sgd import fp32_precision

    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    switch = sys.getswitchinterval()
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    bad = []

    def trainer(seed):
        rng = random.Random(seed)
        for _ in range(200):
            with fp32_precision(torch.device("cuda")):
                if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                    bad.append(seed)
                if rng.random() < 0.5:
                    threading.Event().wait(0.0001)

    try:
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=trainer, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert bad == []
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (
            True, True)
    finally:
        sys.setswitchinterval(switch)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


# -- per-tier edge recovery (the aggregation tree) -------------------------
def _edge_partial(pkg, seed):
    """A PartialSum of an int8 tree under derive_key(0, 0, seed), built by the
    reference (``pkg`` "jax") or the port — the same wire arrays either way."""
    if pkg == "jax":
        from fedml_tpu.hierarchy import PartialSum as JPartialSum

        ct = jc.get_codec("int8").encode({"w": np.ones((8, 4), np.float32) * (1 + seed)},
                                         key=jc.derive_key(0, 0, seed), is_delta=True)
        return JPartialSum(ct, 2.0, 2)
    from fedml_tpu_torch.compression import derive_key, get_codec
    from fedml_tpu_torch.hierarchy import PartialSum

    ct = get_codec("int8").encode({"w": torch.ones(8, 4) * (1 + seed)},
                                  key=derive_key(0, 0, seed), is_delta=True)
    return PartialSum(ct, 2.0, 2)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_edge_aggregator_restores_a_journal_written_by_either_package(tmp_path, writer):
    """An edge killed after two offers: a fresh aggregator of the OTHER
    package restores the open round from the journal and closes it as the
    uninterrupted edge does, bit for bit; the close resets the journal."""
    from fedml_tpu.hierarchy import EdgeAggregator as JEdge
    from fedml_tpu.resilience.durability import RoundJournal as JJournal
    from fedml_tpu_torch.compression import derive_key, get_codec
    from fedml_tpu_torch.hierarchy import EdgeAggregator

    path = str(tmp_path / "edge.journal")
    if writer == "jax":
        a = JEdge(1, 0, [10, 11, 12], jc.get_codec("int8"), quorum_frac=1.0)
        a.bind_journal(JJournal(path))
    else:
        a = EdgeAggregator(1, 0, [10, 11, 12], get_codec("int8"), quorum_frac=1.0,
                           device="cpu")
        a.bind_journal(RoundJournal(path))
    a.begin_round(4)
    assert a.offer(10, _edge_partial(writer, 1)) and a.offer(11, _edge_partial(writer, 2))
    reader = "port" if writer == "jax" else "jax"
    if reader == "jax":
        b = JEdge(1, 0, [10, 11, 12], jc.get_codec("int8"), quorum_frac=1.0)
        b.bind_journal(JJournal(path))
    else:
        b = EdgeAggregator(1, 0, [10, 11, 12], get_codec("int8"), quorum_frac=1.0,
                           device="cpu")
        b.bind_journal(RoundJournal(path))
    assert b.restore_from_journal() == 2
    assert b.received() == 2 and b._round == 4
    assert not b.offer(10, _edge_partial(reader, 9))  # a duplicate is still refused
    assert b.offer(12, _edge_partial(reader, 3))
    key = jc.derive_key(0, 4, 99) if reader == "jax" else derive_key(0, 4, 99)
    restored, missing = b.close_round(key)
    assert missing == [] and restored is not None and restored.weight == 6.0
    c = EdgeAggregator(1, 0, [10, 11, 12], get_codec("int8"), quorum_frac=1.0, device="cpu")
    c.begin_round(4)
    for child, seed in ((10, 1), (11, 2), (12, 3)):
        c.offer(child, _edge_partial("port", seed))
    direct, _ = c.close_round(derive_key(0, 4, 99))
    for pa, pb in zip(restored.ct.arrays, direct.ct.arrays):
        for x, y in zip(pa, pb):
            np.testing.assert_array_equal(_as_np(x), _as_np(y))
    assert b.restore_from_journal() == 0  # the close reset the journal


def test_tree_runner_edge_kill_is_digest_identical(tmp_path):
    from fedml_tpu_torch.hierarchy import (
        EdgeKillWindow,
        TreeRunner,
        TreeTopology,
        default_template,
    )

    def run(chaos, dur_dir):
        return TreeRunner(TreeTopology.build(500, tiers=4), template=default_template(64),
                          codec="int8", seed=3, chaos=chaos, durability_dir=dur_dir,
                          device="cpu").run(3)

    base = run([], None)
    before = (_counter("resilience/restarts"), _counter("resilience/journal_salvaged"),
              _counter("tier/1/restarts"))
    killed = run([EdgeKillWindow(1, 0, 1, after_children=1)], str(tmp_path / "tree"))
    assert killed["final_digest"] == base["final_digest"]
    assert _counter("resilience/restarts") == before[0] + 1
    assert _counter("resilience/journal_salvaged") >= before[1] + 1
    assert _counter("tier/1/restarts") == before[2] + 1
    assert sorted(os.listdir(tmp_path / "tree"))[:2] == ["edge_t0_n0.journal",
                                                         "edge_t1_n0.journal"]
    # an EdgeKillWindow without a journal to restart from is refused
    with pytest.raises(ValueError, match="durability_dir"):
        TreeRunner(TreeTopology.build(100, tiers=3), chaos=[EdgeKillWindow(1, 0, 1)],
                   device="cpu")
