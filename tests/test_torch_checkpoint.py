"""Round checkpoints of the port (``fedml_tpu_torch/core/checkpoint.py``)
beside the JAX package's (``tests/test_checkpoint.py`` mirrored).

A killed-and-resumed port run reproduces the uninterrupted port run bit
for bit on the CPU (params, server-optimizer state, DP counters, SCAFFOLD
and Mime trees); the port's resumed run lands within 1e-5 of the JAX
package's resumed run; a port checkpoint holds the keys of the JAX
package's orbax checkpoint of the same run, with values within 1e-5
(the two runs agree to that bound, ``test_torch_sp_simulation.py``).
"""
import copy
import json
import os

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import arguments as jarguments
from fedml_tpu.data import data_loader as jdl
from fedml_tpu.models import model_hub as jhub
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch.core import checkpoint as tck
from fedml_tpu_torch.cross_silo.run_inproc import run_cross_silo_inproc
from fedml_tpu_torch.data import data_loader as tdl
from fedml_tpu_torch.models import model_hub as thub
from fedml_tpu_torch.models.convert import from_flax_params
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

RESUME_TOL = 1e-5  # port vs JAX runs (XLA's CPU rounding, not the format)


def _reset_port():
    from fedml_tpu_torch.core.alg_frame.params import Context
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    for s in (FedMLAttacker, FedMLDefender, FedMLDifferentialPrivacy, Context):
        s.reset()


def _reset_jax():
    from fedml_tpu.core.alg_frame.params import Context
    from fedml_tpu.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu.core.fhe.fhe_agg import FedMLFHE
    from fedml_tpu.core.security.attacker import FedMLAttacker
    from fedml_tpu.core.security.defender import FedMLDefender

    for s in (FedMLAttacker, FedMLDefender, FedMLDifferentialPrivacy, FedMLFHE, Context):
        s.reset()


@pytest.fixture(autouse=True)
def fresh_singletons():
    _reset_port()
    _reset_jax()
    yield
    _reset_port()
    _reset_jax()


def _cfg(rounds, ckpt_dir=None, resume=False, **over):
    train = {"federated_optimizer": "FedOpt", "server_optimizer": "sgd",
             "server_lr": 1.0, "server_momentum": 0.9, "client_num_in_total": 4,
             "client_num_per_round": 4, "comm_round": rounds, "epochs": 1,
             "batch_size": 16, "learning_rate": 0.1, "frequency_of_the_test": 100}
    if ckpt_dir:
        train.update({"checkpoint_dir": str(ckpt_dir), "resume": resume})
    train.update(over)
    return {"common_args": {"training_type": "simulation", "random_seed": 0},
            "data_args": {"dataset": "synthetic", "train_size": 400, "test_size": 100,
                          "class_num": 4, "feature_dim": 12},
            "model_args": {"model": "lr"}, "train_args": train}


def _port_run(cfg, init=None):
    """A port run; ``init`` (the JAX package's initial model) replaces the
    port's own draw, unless the run resumes."""
    _reset_port()
    args = fedml_tpu_torch.init(targuments.load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = tdl.load_federated(args)
    api = FedAvgAPI(args, "cpu", ds, thub.create(args, ds.class_num))
    if init is not None and not getattr(args, "resume", False):
        api.global_params = from_flax_params(init)
    api.train()
    return api


def _jax_run(cfg):
    """A JAX run and its initial model (numpy)."""
    from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

    _reset_jax()
    args = fedml_tpu.init(jarguments.load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = jdl.load_federated(args)
    api = JFedAvgAPI(args, None, ds, jhub.create(args, ds.class_num))
    init = jax.tree.map(np.asarray, api.global_params)
    api.train()
    return api, init


def _params(api):
    return {k: v.detach().clone() for k, v in api.global_params.items()}


def _equal(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


OPTIMIZERS = {
    "FedOpt-sgd": {},
    "FedOpt-adam": {"server_optimizer": "adam", "server_lr": 0.05},
    "SCAFFOLD": {"federated_optimizer": "SCAFFOLD"},
    "Mime": {"federated_optimizer": "Mime"},
}


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_sp_kill_and_resume_bit_exact(tmp_path, opt):
    """Crash after round 2, resume to round 6: the uninterrupted run's
    parameters bit for bit (server momentum, adam moments, SCAFFOLD's
    control variate and Mime's momentum are in the checkpoint)."""
    over = OPTIMIZERS[opt]
    straight = _params(_port_run(_cfg(6, **over)))
    _port_run(_cfg(3, tmp_path / "ck", **over))
    resumed = _port_run(_cfg(6, tmp_path / "ck", resume=True, **over))
    assert resumed._start_round == 6
    _equal(straight, _params(resumed))


def test_sp_resume_with_dp_counter(tmp_path):
    """The resumed run draws the same LDP noise keys: the counter is saved."""
    dp = {"enable_dp": True, "dp_solution_type": "LDP", "epsilon": 5.0, "delta": 1e-5,
          "clipping_norm": 1.0}
    straight = _params(_port_run(_cfg(4, **dp)))
    _port_run(_cfg(2, tmp_path / "ck", **dp))
    with open(tmp_path / "ck" / "round_1" / "manifest.json") as f:
        assert json.load(f)["keys"]["dp_counter"] == {"dtype": "int32", "shape": []}
    state = tck.read_round_dir(str(tmp_path / "ck" / "round_1"))
    assert int(state["dp_counter"]) == 8  # 4 clients x 2 rounds of releases
    _equal(straight, _params(_port_run(_cfg(4, tmp_path / "ck", resume=True, **dp))))


def test_dp_streams_round_trip(tmp_path):
    """In-process silos' DP streams are saved under their rank and come back."""
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )

    args = fedml_tpu_torch.init(targuments.load_arguments_from_dict(
        _cfg(1, enable_dp=True, dp_solution_type="LDP", epsilon=5.0, delta=1e-5,
             clipping_norm=1.0)))
    dp = FedMLDifferentialPrivacy.get_instance()
    dp.take_key_data(3)
    dp.take_key_data(2, stream=1)
    dp.take_key_data(5, stream=2)
    params = {"params/Dense_0/kernel": torch.ones(3, 2), "params/Dense_0/bias": torch.ones(3)}
    ck = tck.RoundCheckpointer(str(tmp_path / "ck"))
    template = tck.pack_round_state(params, None, 1)
    assert template["dp_counter"] == 3 and template["dp_streams"] == {"1": 2, "2": 5}
    ck.save(0, template)
    _reset_port()
    fedml_tpu_torch.init(args)
    fresh = tck.pack_round_state(params, None, 0)
    assert "dp_streams" not in fresh
    _, state = ck.restore_latest(fresh)
    assert tck.apply_round_state(state) == 1
    assert FedMLDifferentialPrivacy.get_instance().counters() == {None: 3, 1: 2, 2: 5}


def test_resumed_run_matches_the_jax_resumed_run(tmp_path):
    """The port's kill-and-resume beside the JAX package's on the same LR
    config: final parameters within RESUME_TOL."""
    _, init = _jax_run(_cfg(2, tmp_path / "jax"))
    ref, _ = _jax_run(_cfg(4, tmp_path / "jax", resume=True))
    _port_run(_cfg(2, tmp_path / "port"), init)
    port = _port_run(_cfg(4, tmp_path / "port", resume=True))
    want = from_flax_params(jax.tree.map(np.asarray, ref.global_params))
    for k, v in want.items():
        np.testing.assert_allclose(port.global_params[k].numpy(), v.numpy(), rtol=0,
                                   atol=RESUME_TOL)


def _orbax_flat(path, template):
    """The JAX package's orbax round, flattened to ``/``-joined key paths."""
    from fedml_tpu.core.checkpoint import RoundCheckpointer as JCheckpointer

    ck = JCheckpointer(os.path.dirname(path))
    state = ck.restore(int(os.path.basename(path).split("_")[1]), template)

    def name(k):
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    leaves, _ = jax.tree_util.tree_flatten_with_path(state)
    return {"/".join(name(k) for k in p): np.asarray(v) for p, v in leaves}


@pytest.mark.parametrize("opt", ["FedOpt-sgd", "FedOpt-adam", "SCAFFOLD"])
def test_checkpoint_keys_and_values_match_jax_orbax(tmp_path, opt):
    """Both packages checkpoint the same LR run: the port's round directory
    holds exactly the orbax checkpoint's keys, dtypes and shapes (kernels in
    the reference's layout), and its values within RESUME_TOL."""
    over = OPTIMIZERS[opt]
    jax_api, init = _jax_run(_cfg(2, tmp_path / "jax", **over))
    _port_run(_cfg(2, tmp_path / "port", **over), init)
    want = _orbax_flat(str(tmp_path / "jax" / "round_1"), jax_api._ckpt_state())
    got = tck.read_round_dir(str(tmp_path / "port" / "round_1"))
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, (k, g.shape, w.shape, g.dtype)
        np.testing.assert_allclose(g, w, rtol=0, atol=RESUME_TOL, err_msg=k)
    assert int(got["next_round"]) == 2


def test_checkpointer_prunes_old_rounds(tmp_path):
    ck = tck.RoundCheckpointer(str(tmp_path / "ck"), keep=2)
    for r in range(5):
        ck.save(r, {"x": torch.arange(3, dtype=torch.float32) + r})
    assert ck.saved_rounds() == [3, 4]
    state = ck.restore(4, {"x": torch.zeros(3)})
    assert torch.equal(state["x"], torch.arange(3, dtype=torch.float32) + 4)


def test_restore_latest_falls_back_past_a_truncated_round(tmp_path):
    """A half-written newest round (its state file cut short) is skipped,
    the round before it restored, and the broken one pruned."""
    ck = tck.RoundCheckpointer(str(tmp_path / "ck"))
    for r in range(3):
        ck.save(r, {"x": torch.full((4, 4), float(r)), "next_round": r + 1})
    state_file = tmp_path / "ck" / "round_2" / tck.STATE_FILE
    data = state_file.read_bytes()
    state_file.write_bytes(data[: len(data) // 2])
    got = ck.restore_latest({"x": torch.zeros(4, 4), "next_round": 0})
    assert got is not None and got[0] == 1
    assert torch.equal(got[1]["x"], torch.full((4, 4), 1.0))
    assert int(got[1]["next_round"]) == 2
    assert ck.saved_rounds() == [0, 1]


def test_restore_latest_keeps_every_round_on_a_template_mismatch(tmp_path):
    """A template no round fits is a changed model, not crash damage: it
    raises and prunes nothing."""
    ck = tck.RoundCheckpointer(str(tmp_path / "ck"))
    for r in range(2):
        ck.save(r, {"x": torch.zeros(3)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore_latest({"x": torch.zeros(5)})
    assert ck.saved_rounds() == [0, 1]


def test_orphaned_staging_removed(tmp_path):
    """Staging directories a crash left behind (the port's and orbax's
    names) are removed before a restore; a round without its manifest is
    never listed as restorable past a good one."""
    ck = tck.RoundCheckpointer(str(tmp_path / "ck"))
    ck.save(0, {"x": torch.ones(2)})
    for name in ("round_1.tmp-0123456789ab", "round_1.orbax-checkpoint-tmp-17"):
        os.makedirs(tmp_path / "ck" / name)
        (tmp_path / "ck" / name / tck.STATE_FILE).write_bytes(b"partial")
    got = ck.restore_latest({"x": torch.zeros(2)})
    assert got[0] == 0 and torch.equal(got[1]["x"], torch.ones(2))
    assert sorted(os.listdir(tmp_path / "ck")) == ["round_0"]


def test_round_dir_reads_only_tensors(tmp_path):
    """The state file loads with ``weights_only``: a pickled object in it is
    refused, and a manifest that disagrees with the file raises."""
    path = str(tmp_path / "round_0")
    tck.write_round_dir(path, {"a": torch.ones(2, dtype=torch.bfloat16)}, 0)
    assert tck.read_round_dir(path)["a"].dtype == torch.bfloat16
    torch.save({"a": torch.ones(2, dtype=torch.bfloat16), "evil": object()},
               os.path.join(path, tck.STATE_FILE))
    with pytest.raises(Exception):
        tck.read_round_dir(path)
    torch.save({"a": torch.ones(3)}, os.path.join(path, tck.STATE_FILE))
    with pytest.raises(ValueError, match="manifest"):
        tck.read_round_dir(path)


def test_server_optimizer_state_round_trips_in_optax_keys():
    """``get_state`` keys the state as optax's flatten does; ``set_state``
    of it restores the optimizer, and the next step is the same."""
    from fedml_tpu_torch.ml.aggregator.server_optimizer import ServerOptimizer

    class A:
        federated_optimizer, server_optimizer, server_lr, server_momentum = (
            "FedOpt", "adam", 0.1, 0.9)

    g = {"params/b": torch.ones(3), "params/a": torch.full((2, 2), 2.0)}
    w = {k: v * 0.5 for k, v in g.items()}
    opt = ServerOptimizer(A())
    g1 = opt.step(g, w)
    state = opt.get_state(g1)
    assert sorted(state["0"]) == ["count", "mu", "nu"] and int(state["0"]["count"]) == 1
    assert list(state["0"]["mu"]) == ["params/a", "params/b"]
    twin = ServerOptimizer(A())
    twin.set_state(state)
    _equal(opt.step(g1, w), twin.step(g1, w))


def _cs_cfg(rounds, run_id, ckpt=None, resume=False, **over):
    extra = {"checkpoint_dir": str(ckpt), "resume": resume} if ckpt else {}
    return {"common_args": {"training_type": "cross_silo", "random_seed": 0,
                            "run_id": run_id},
            "data_args": {"dataset": "synthetic", "train_size": 400, "test_size": 100,
                          "class_num": 4, "feature_dim": 12},
            "model_args": {"model": "lr"},
            "train_args": {"federated_optimizer": "FedOpt", "server_optimizer": "sgd",
                           "server_lr": 1.0, "server_momentum": 0.9,
                           "client_num_in_total": 3, "client_num_per_round": 3,
                           "comm_round": rounds, "epochs": 1, "batch_size": 32,
                           "learning_rate": 0.3, **extra, **over}}


def _cs_run(cfg):
    _reset_port()
    args = fedml_tpu_torch.init(targuments.load_arguments_from_dict(copy.deepcopy(cfg)))
    ds = tdl.load_federated(args)
    return run_cross_silo_inproc(args, ds, thub.create(args, ds.class_num), timeout=120,
                                 device="cpu")


def test_cross_silo_server_resume(tmp_path):
    """A restarted server re-enters at the saved round with the model and
    the server momentum: the resumed federation ends as the uninterrupted
    one; resuming a finished run trains no extra round."""
    straight = _cs_run(_cs_cfg(4, "torch_ck_straight"))
    _cs_run(_cs_cfg(2, "torch_ck_part1", tmp_path / "ck"))
    resumed = _cs_run(_cs_cfg(4, "torch_ck_part2", tmp_path / "ck", resume=True))
    assert resumed["test_loss"] == straight["test_loss"]
    assert resumed["test_acc"] == straight["test_acc"]
    before = tck.RoundCheckpointer(str(tmp_path / "ck")).saved_rounds()
    assert before == [1, 2, 3]
    done = _cs_run(_cs_cfg(4, "torch_ck_part3", tmp_path / "ck", resume=True))
    assert done["rounds"] == 4 and done["test_loss"] == straight["test_loss"]
    assert tck.RoundCheckpointer(str(tmp_path / "ck")).saved_rounds() == before


def test_cross_silo_rollback_restores_the_checkpoint(tmp_path):
    """Ring 3 rejects a non-finite aggregate: the server restores the newest
    checkpoint (the last accepted round) bit for bit, re-runs the round and
    ends finite."""
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.run_inproc import (
        build_cross_silo_inproc,
        run_managers_to_completion,
    )
    from fedml_tpu_torch.models.convert import from_reference_layout

    cfg = _cs_cfg(3, "torch_ck_rollback", tmp_path / "ck", integrity=True,
                  integrity_norm_mult=1e9, integrity_z_threshold=1e9)
    args = fedml_tpu_torch.init(targuments.load_arguments_from_dict(cfg))
    ds = tdl.load_federated(args)
    server, clients = build_cross_silo_inproc(args, ds, thub.create(args, ds.class_num),
                                              "cpu")
    manager, agg = server.manager, server.fedml_aggregator
    aggregate, rollback = agg.aggregate, manager._rollback_round
    seen = []

    def poisoned_once():
        out = aggregate()
        if int(args.round_idx) == 1 and not seen:
            agg.global_params = out = {k: v * float("nan") for k, v in out.items()}
        return out

    def recorded_rollback(reason):
        rollback(reason)
        saved = tck.read_round_dir(str(tmp_path / "ck" / "round_0"))
        want = from_reference_layout({k.removeprefix("global_params/"): v
                                      for k, v in saved.items()
                                      if k.startswith("global_params/")})
        seen.append(all(torch.equal(agg.global_params[k], want[k]) for k in want))

    agg.aggregate, manager._rollback_round = poisoned_once, recorded_rollback
    run_managers_to_completion([manager] + [c.manager for c in clients], args.run_id,
                               MyMessage.MSG_TYPE_CONNECTION_IS_READY, 120)
    assert seen == [True]
    assert manager.result is not None and np.isfinite(manager.result["test_loss"])
    assert manager._guard.total_rollbacks == 1
