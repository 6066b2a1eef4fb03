"""Contribution assessment of the port (``fedml_tpu_torch/core/contribution``)
beside the JAX package's (``tests/test_contribution.py`` mirrored).

The games are host numpy in both packages: the port's values equal the JAX
functions' (1e-12). In the engines the utility is a coalition aggregate's
test accuracy, which the two packages compute from models that agree
within 1e-5: on the runs below the same predictions, so the same values
(1e-9)."""
import copy
import itertools

import jax
import numpy as np
import pytest

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import arguments as jarguments
from fedml_tpu.core import contribution as jcontrib
from fedml_tpu.core.contribution.gtg_shapley import mr_shapley as jmr
from fedml_tpu.data import data_loader as jdl
from fedml_tpu.models import model_hub as jhub
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch.core import contribution as tcontrib
from fedml_tpu_torch.core.contribution.gtg_shapley import mr_shapley as tmr
from fedml_tpu_torch.data import data_loader as tdl
from fedml_tpu_torch.models import model_hub as thub
from fedml_tpu_torch.models.convert import from_flax_params
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

VALUE_TOL = 1e-9


def _reset():
    from fedml_tpu.core.alg_frame.params import Context as JContext
    from fedml_tpu.core.security.attacker import FedMLAttacker as JAttacker
    from fedml_tpu_torch.core.alg_frame.params import Context
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker

    for s in (JContext, JAttacker, Context, FedMLAttacker):
        s.reset()


@pytest.fixture(autouse=True)
def fresh():
    _reset()
    yield
    _reset()


_W = np.asarray([3.0, 1.0, 2.0])
_RNG_VALS = {frozenset(s): float(np.random.default_rng(len(s) * 7 + sum(s)).random())
             for r in range(1, 7) for s in itertools.combinations(range(6), r)}


def _random_game(s):
    return _RNG_VALS.get(frozenset(s), 0.0)


GAMES = {
    # name: (n, utility, v(empty), keyword arguments of gtg_shapley)
    "additive": (3, lambda s: float(sum(_W[list(s)])), 0.0, {}),
    "glove": (3, lambda s: 1.0 if 0 in set(s) and (1 in set(s) or 2 in set(s)) else 0.0,
              0.0, {}),
    "random-exact": (4, _random_game, 0.25, {}),
    "monte-carlo": (6, _random_game, 0.1, dict(max_permutations=40, eps=0.0,
                                               convergence_tol=0.0, seed=3)),
    "mc-converging": (6, _random_game, 0.1, dict(max_permutations=64, seed=5)),
    "truncated": (6, lambda s: 1.0 - 0.5 ** len(s), 0.0,
                  dict(max_permutations=30, eps=0.05, exact_threshold=2, seed=2)),
}


@pytest.mark.parametrize("game", sorted(GAMES))
def test_gtg_shapley_equals_the_reference(game):
    n, v, empty, kw = GAMES[game]
    got = tcontrib.gtg_shapley(n, v, empty, **kw)
    want = jcontrib.gtg_shapley(n, v, empty, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("game", ["additive", "glove", "random-exact"])
def test_mr_shapley_and_leave_one_out_equal_the_reference(game):
    n, v, empty, _ = GAMES[game]
    np.testing.assert_allclose(tmr(n, v, empty), jmr(n, v, empty), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tcontrib.leave_one_out(n, v), jcontrib.leave_one_out(n, v),
                               rtol=0, atol=1e-12)


def test_exact_shapley_known_values():
    np.testing.assert_allclose(tcontrib.gtg_shapley(3, GAMES["additive"][1], 0.0), _W,
                               atol=1e-12)
    np.testing.assert_allclose(tcontrib.gtg_shapley(3, GAMES["glove"][1], 0.0),
                               [2 / 3, 1 / 6, 1 / 6], atol=1e-12)
    phi = tmr(4, _random_game, 0.25)
    assert abs(phi.sum() - (_random_game(range(4)) - 0.25)) < 1e-9  # efficiency


def test_truncation_caches_and_truncates():
    calls = []

    def v(s):
        calls.append(tuple(s))
        return 1.0

    tcontrib.gtg_shapley(6, v, 1.0, max_permutations=50, eps=1e-3, exact_threshold=2)
    assert len(calls) == 1


def test_mr_round_truncation_matches_the_reference():
    import types

    import torch

    args = types.SimpleNamespace(enable_contribution=True, contribution_method="mr_shapley",
                                 contribution_round_trunc=0.05, random_seed=0)
    calls = []

    def util(p):
        calls.append(1)
        return 0.501

    got = tcontrib.ContributionAssessorManager(args).run(
        [0, 1], [(1, {"w": torch.ones(2)}), (1, {"w": torch.ones(2)})], util, 0.5)
    want = jcontrib.ContributionAssessorManager(args).run(
        [0, 1], [(1, {"w": np.ones(2)}), (1, {"w": np.ones(2)})], lambda p: 0.501, 0.5)
    assert got == want == {0: 0.0, 1: 0.0} and len(calls) == 1


def _lr_cfg(method="gtg_shapley", **train):
    return {
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": "synthetic", "train_size": 600, "test_size": 150,
                      "class_num": 4, "feature_dim": 16},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": 3, "epochs": 2,
                       "batch_size": 16, "learning_rate": 0.2, **train},
        "contribution_args": {"enable_contribution": True,
                              "contribution_method": method},
    }


def _poison(ds, cid=2):
    x, y = ds.train_data_local_dict[cid]
    ds.train_data_local_dict[cid] = (x, np.random.default_rng(0).permutation(np.asarray(y)))


def _sp_pair(cfg, poison=True):
    from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI

    jargs = fedml_tpu.init(jarguments.load_arguments_from_dict(copy.deepcopy(cfg)))
    jds = jdl.load_federated(jargs)
    targs = fedml_tpu_torch.init(targuments.load_arguments_from_dict(copy.deepcopy(cfg)))
    tds = tdl.load_federated(targs)
    if poison:
        _poison(jds)
        _poison(tds)
    japi = JFedAvgAPI(jargs, None, jds, jhub.create(jargs, jds.class_num))
    tapi = FedAvgAPI(targs, "cpu", tds, thub.create(targs, tds.class_num))
    tapi.global_params = from_flax_params(jax.tree.map(np.asarray, japi.global_params))
    return japi, tapi


@pytest.mark.parametrize("method", ["gtg_shapley", "leave_one_out", "mr_shapley"])
def test_sp_contributions_match_the_reference(method):
    """One LR run with a label-shuffled client in both packages: each
    round's values and the accumulated ones equal the JAX package's."""
    japi, tapi = _sp_pair(_lr_cfg(method))
    for r in range(3):
        rep = tapi.train_one_round(r)
        japi.train_one_round(r)
        assert rep["contribution_utility_calls"] >= 2
    assert set(tapi._contrib.accumulated) == set(japi._contrib.accumulated) == {0, 1, 2}
    for cid, v in japi._contrib.accumulated.items():
        assert abs(tapi._contrib.accumulated[cid] - v) <= VALUE_TOL, (cid, v)


def test_fl_contribution_ranks_poisoned_client_last():
    """The port alone: the label-shuffled client is valued lowest, well
    below the best honest client, and the Context holds the values."""
    from fedml_tpu_torch.core.alg_frame.params import Context

    targs = fedml_tpu_torch.init(targuments.load_arguments_from_dict(_lr_cfg()))
    ds = tdl.load_federated(targs)
    _poison(ds)
    api = FedAvgAPI(targs, "cpu", ds, thub.create(targs, ds.class_num))
    api.train()
    acc = api._contrib.accumulated
    assert acc[2] == min(acc.values()) and max(acc.values()) > acc[2] + 0.05, acc
    assert Context().get(Context.KEY_CLIENT_CONTRIBUTIONS) == acc


def test_contribution_forces_the_decode_path_under_a_codec():
    """With int8 uplinks the values need the client models: every upload
    is decoded, and the run still agrees with the reference's."""
    japi, tapi = _sp_pair(_lr_cfg(compression="int8", comm_round=1), poison=False)
    tapi.train_one_round(0)
    japi.train_one_round(0)
    for cid, v in japi._contrib.accumulated.items():
        assert abs(tapi._contrib.accumulated[cid] - v) <= VALUE_TOL, (cid, v)


def test_cross_silo_contributions_match_the_reference():
    """The in-process cross-silo federation (3 silos, leave-one-out and
    GTG): the aggregator's accumulated values equal the JAX package's."""
    from test_torch_cross_silo import _cfg, _jax_fed, _jax_init, _port_fed, _run_local

    for method in ("leave_one_out", "gtg_shapley"):
        cfg = _cfg(enable_contribution=True, contribution_method=method)
        ref = _jax_fed(cfg)
        port = _port_fed(cfg, _jax_init(ref))
        fedml_tpu_torch.init(port.server.args)
        _run_local(ref)
        _run_local(port)
        want = ref.server.fedml_aggregator._contrib.accumulated
        got = port.server.fedml_aggregator._contrib.accumulated
        assert set(got) == set(want) and len(got) == 3
        for cid, v in want.items():
            assert abs(got[cid] - v) <= VALUE_TOL, (method, cid, got[cid], v)
