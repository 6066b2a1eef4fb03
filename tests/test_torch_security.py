"""The port's attacks and defenses (``fedml_tpu_torch/core/security``)
against the reference's (``fedml_tpu/core/security``) on the CPU, on the
same cohort made from a seed with numpy — six clients of a tree with a conv
kernel (HWIO in the reference, OIHW in the port), a dense kernel and a
bias, client 0 byzantine (its update ×30 plus noise):

* every registered defense, through the ``FedMLDefender`` singletons, over
  two rounds (the stateful ones carry state): ``defend_before_aggregation``
  keeps the same clients with the same values, ``defend_on_aggregation``
  and ``defend_after_aggregation`` agree within 1e-5 of each value's
  magnitude (floored at 1) — and within ``2e-5·σ`` more for the noising
  ones (σ their noise scale: the draws differ by ``erfinv``'s few ulp);
* the blockwise paths at a block width that splits leaves, against the
  reference's blockwise functions and the port's dense ones (1e-5; the
  gram's distances within 1e-5 of the largest one);
* each ported attack against the reference on the same seed (data attacks
  bit for bit, model attacks within the same bounds), and the
  reconstruction attacks built by the singleton (ROADMAP A10.2c; what they
  compute is held in ``test_torch_reconstruction.py``);
* ``fused_clip_factors`` on int8 deltas (1e-6 relative) and its counter.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import compression as jc
from fedml_tpu.core.alg_frame.params import Context as JContext
from fedml_tpu.core.security.attacker import FedMLAttacker as JAttacker
from fedml_tpu.core.security.defender import FedMLDefender as JDefender
from fedml_tpu.core.security.defense import blockwise as jbw
from fedml_tpu.ml.aggregator.agg_operator import FedMLAggOperator as JAgg
from fedml_tpu.telemetry import get_registry as jregistry
from fedml_tpu_torch import compression as tc
from fedml_tpu_torch.core.alg_frame.params import Context as TContext
from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from fedml_tpu_torch.core.security.attack import available_attacks
from fedml_tpu_torch.core.security.attacker import FedMLAttacker as TAttacker
from fedml_tpu_torch.core.security.defender import FedMLDefender as TDefender
from fedml_tpu_torch.core.security.defense import available_defenses
from fedml_tpu_torch.core.security.defense import blockwise as tbw
from fedml_tpu_torch.core.security.defense.base import pairwise_sq_dists, stack_updates
from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator as TAgg
from fedml_tpu_torch.models.convert import from_flax_params, to_reference_layout
from fedml_tpu_torch.telemetry import get_registry as tregistry

TOL = 1e-5
NOISE_TOL = 2e-5


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    yield
    TAttacker.reset()
    TDefender.reset()
    FedMLDifferentialPrivacy.reset()
    TContext.reset()


def _flax(rng, scale=1.0):
    return {"params": {
        "Conv_0": {"kernel": (rng.normal(size=(3, 3, 2, 4)) * scale).astype(np.float32),
                   "bias": (rng.normal(size=(4,)) * scale).astype(np.float32)},
        "Dense_0": {"kernel": (rng.normal(size=(7, 5)) * scale).astype(np.float32)}}}


def _cohort(n=6, seed=0, round_idx=0):
    """``[(n_k, flax tree)]``: client updates around a shared center, client 0
    byzantine."""
    rng = np.random.default_rng(seed + 100 * round_idx)
    center = _flax(np.random.default_rng(seed), 0.5)
    out = []
    for c in range(n):
        d = _flax(rng, 0.1)
        tree = jax.tree.map(lambda a, b: a + b, center, d)
        if c == 0:
            tree = jax.tree.map(lambda a: a * np.float32(30.0), tree)
        out.append((float(10 + 3 * c), tree))
    return out


def _jlist(cohort):
    return [(n, jax.tree.map(jnp.asarray, t)) for n, t in cohort]


def _tlist(cohort):
    return [(n, from_flax_params(t)) for n, t in cohort]


def _close_tree(got, want_flax, tol=TOL, noise=0.0):
    want = from_flax_params(jax.tree.map(np.asarray, want_flax))
    assert list(got) == list(want)
    for k in want:
        w = want[k].numpy().astype(np.float64)
        bound = tol * max(1.0, float(np.abs(w).max())) + NOISE_TOL * noise
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= bound, f"{k}: {err:.3e} > {bound:.3e}"


DEFENSE_ARGS = dict(random_seed=5, byzantine_client_num=1, beta=0.2, trim_param_b=1,
                    cclip_tau=1.0, norm_bound=1.0, robust_threshold=4.0,
                    soteria_percentile=30.0, stddev=0.01, crfl_sigma=0.02,
                    crfl_clip_threshold=5.0, geo_median_iters=5)
NOISY = {"crfl": "crfl_sigma", "weak_dp": "stddev"}


def test_the_registry_is_the_reference_s():
    from fedml_tpu.core.security.defense import (
        available_defenses as javailable,
        create_defender,
    )

    create_defender("krum", types.SimpleNamespace())  # loads the reference's registry
    assert available_defenses() == javailable()
    assert len(available_defenses()) == 23


@pytest.mark.parametrize("name", available_defenses())
def test_defense_matches_reference(name):
    args = types.SimpleNamespace(enable_defense=True, defense_type=name, **DEFENSE_ARGS)
    JDefender.reset()
    jd, td = JDefender.get_instance(), TDefender.get_instance()
    jd.init(args)
    td.init(args)
    assert type(td.defender).__name__ == type(jd.defender).__name__
    noise = DEFENSE_ARGS.get(NOISY.get(name), 0.0)
    for r in range(2):
        cohort = _cohort(round_idx=r)
        jb = jd.defend_before_aggregation(_jlist(cohort), None)
        tb = td.defend_before_aggregation(_tlist(cohort), None)
        assert len(tb) == len(jb)
        for (tn, tt), (jn, jt) in zip(tb, jb):
            assert float(tn) == float(jn)
            _close_tree(tt, jt)
        jagg = jd.defend_on_aggregation(_jlist(cohort), JAgg.agg, None)
        tagg = td.defend_on_aggregation(_tlist(cohort), TAgg.agg, None)
        _close_tree(tagg, jagg)
        want = jax.tree.map(jnp.asarray, cohort[1][1])
        _close_tree(td.defend_after_aggregation(from_flax_params(cohort[1][1])),
                    jd.defend_after_aggregation(want), noise=noise)
    JDefender.reset()


def _flat_pairs(cohort):
    jtrees = [jax.tree.map(np.asarray, t) for _, t in cohort]
    # the port's trees in the reference's layout: the same flattened order
    ttrees = [{k: v.contiguous() for k, v in to_reference_layout(from_flax_params(t)).items()}
              for _, t in cohort]
    return jtrees, ttrees


@pytest.mark.parametrize("block", [7, 50, 1 << 20])
def test_blockwise_paths_match_reference_and_dense(block):
    cohort = _cohort()
    jtrees, ttrees = _flat_pairs(cohort)
    n = len(cohort)
    want = jbw.pairwise_sq_dists_blockwise(jbw.iter_blocks(jbw.flatten_clients(jtrees),
                                                           block), n)
    got = tbw.pairwise_sq_dists_blockwise(tbw.iter_blocks(tbw.flatten_clients(ttrees),
                                                          block), n)
    # d_ij = g_ii + g_jj - 2 g_ij cancels: within 1e-5 of the largest distance
    scale = TOL * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=scale)
    dense = pairwise_sq_dists(stack_updates([(1, t) for t in ttrees])[0]).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=scale)
    pairs = [
        (tbw.trimmed_mean_blockwise(ttrees, 1, block), jbw.trimmed_mean_blockwise(
            jtrees, 1, block)),
        (tbw.coordinate_median_blockwise(ttrees, block),
         jbw.coordinate_median_blockwise(jtrees, block)),
        (tbw.geometric_median_blockwise(ttrees, [n_ for n_, _ in cohort], 5,
                                        block_elems=block),
         jbw.geometric_median_blockwise(jtrees, [n_ for n_, _ in cohort], 5,
                                        block_elems=block)),
    ]
    for got_tree, want_tree in pairs:
        for k, v in got_tree.items():
            w = np.asarray(want_tree["params"][k.split("/")[1]][k.split("/")[2]])
            bound = TOL * max(1.0, float(np.abs(w).max()))
            assert float(np.abs(v.numpy() - w).max()) <= bound, k


@pytest.mark.parametrize("name", ["krum", "geometric_median", "trimmed_mean",
                                  "coordinate_wise_median"])
def test_forced_blockwise_defenses_match_reference(name):
    """Past the stack budget (here one byte) the port's defenses stream,
    and still give the reference's dense answer."""
    args = types.SimpleNamespace(enable_defense=True, defense_type=name, **DEFENSE_ARGS)
    targs = types.SimpleNamespace(defense_stack_budget_bytes=1, **vars(args))
    JDefender.reset()
    jd, td = JDefender.get_instance(), TDefender.get_instance()
    jd.init(args)
    td.init(targs)
    cohort = _cohort()
    jb = jd.defend_before_aggregation(_jlist(cohort), None)
    tb = td.defend_before_aggregation(_tlist(cohort), None)
    assert [n for n, _ in tb] == [n for n, _ in jb]
    _close_tree(td.defend_on_aggregation(_tlist(cohort), TAgg.agg, None),
                jd.defend_on_aggregation(_jlist(cohort), JAgg.agg, None))
    if name == "krum":
        assert [n for n, _ in tb] != [cohort[0][0]]  # the byzantine client is out
    JDefender.reset()


def _attack_args(name, **kw):
    return types.SimpleNamespace(enable_attack=True, attack_type=name, random_seed=7, **kw)


@pytest.mark.parametrize("name,kw", [
    ("byzantine", {"attack_mode": "random", "byzantine_client_num": 2}),
    ("byzantine", {"attack_mode": "zero"}),
    ("byzantine", {"attack_mode": "flip"}),
    ("model_replacement", {}),
    ("model_replacement", {"replacement_scale": 3.0}),
    ("lazy_worker", {"lazy_worker_num": 2, "lazy_camouflage_std": 0.01}),
])
def test_model_attacks_match_reference(name, kw):
    args = _attack_args(name, **kw)
    JAttacker.reset()
    ja, ta = JAttacker.get_instance(), TAttacker.get_instance()
    ja.init(args)
    ta.init(args)
    assert ta.is_model_attack() and ja.is_model_attack()
    base = _cohort()[2][1]
    JContext().add("global_model_for_defense", jax.tree.map(jnp.asarray, base))
    TContext().add("global_model_for_defense", from_flax_params(base))
    for r in range(2):  # the random draws advance a counter
        cohort = _cohort(round_idx=r)
        aux = (None, None) if name != "model_replacement" or r == 0 else (
            jax.tree.map(jnp.asarray, base), from_flax_params(base))
        jout = ja.attack_model(_jlist(cohort), aux[0])
        tout = ta.attack_model(_tlist(cohort), aux[1])
        assert len(tout) == len(jout)
        for (tn, tt), (jn, jt) in zip(tout, jout):
            assert tn == jn
            _close_tree(tt, jt, noise=1.0 if kw.get("attack_mode") == "random" else 0.0)
    JAttacker.reset()


def _images(seed=0, n=40):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 6, 6, 3)).astype(np.float32),
            rng.integers(0, 5, size=n).astype(np.int32))


@pytest.mark.parametrize("name,kw,flat", [
    ("label_flipping", {"poisoned_ratio": 0.5}, False),
    ("label_flipping", {"original_class_list": [1, 2], "target_class_list": [3, 0]}, False),
    ("backdoor", {"poisoned_ratio": 0.3, "backdoor_target_class": 4}, False),
    ("backdoor", {"poisoned_ratio": 0.3, "trigger_size": 2}, True),
    ("edge_case_backdoor", {"poisoned_ratio": 0.2}, False),
])
def test_data_attacks_match_reference_bit_for_bit(name, kw, flat):
    args = _attack_args(name, **kw)
    JAttacker.reset()
    ja, ta = JAttacker.get_instance(), TAttacker.get_instance()
    ja.init(args)
    ta.init(args)
    assert ta.is_data_poisoning_attack() and ta.is_to_poison_data()
    for call in range(2):  # the generators advance
        x, y = _images(call)
        if flat:
            x = x.reshape(len(x), -1)
        jx, jy = ja.poison_data((x.copy(), y.copy()))
        tx, ty = ta.poison_data((x.copy(), y.copy()))
        assert np.array_equal(np.asarray(tx), np.asarray(jx))
        assert np.array_equal(np.asarray(ty), np.asarray(jy))
    JAttacker.reset()


def test_data_poisoning_in_the_trainer_hook_keys_by_stream():
    """A silo's stream poisons as a fresh attacker would, whatever the other
    silos drew before; the sp trainer (no stream) uses the process's."""
    from fedml_tpu.core.alg_frame.client_trainer import ClientTrainer as JTrainer
    from fedml_tpu_torch.core.alg_frame.client_trainer import ClientTrainer as TTrainer

    class J(JTrainer):
        def train(self, *a):
            pass

    class T(TTrainer):
        def train(self, *a):
            pass

    args = _attack_args("label_flipping", poisoned_ratio=0.5)
    TAttacker.get_instance().init(args)
    data = _images()
    other, silo = T(None, args), T(None, args)
    other.trust_stream, silo.trust_stream = 1, 2
    other.on_before_local_training({}, data, "cpu", args)
    _, got = silo.on_before_local_training({}, data, "cpu", args)
    JAttacker.reset()
    JAttacker.get_instance().init(args)
    _, want = J(None, args).on_before_local_training({}, data, None, args)
    assert np.array_equal(got[1], want[1])
    JAttacker.reset()


@pytest.mark.parametrize("name", ["dlg", "invert_gradient", "revealing_labels",
                                  "revealing_labels_from_gradients"])
def test_reconstruction_attacks_raise_naming_a10_2c(name):
    """Ported with ROADMAP A10.2c: the singleton builds each reconstruction
    attack, as the reference's does (``test_torch_reconstruction.py`` holds
    what they compute)."""
    assert name in available_attacks()
    TAttacker.get_instance().init(_attack_args(name))
    JAttacker.reset()
    JAttacker.get_instance().init(_attack_args(name))
    try:
        assert TAttacker.get_instance().is_reconstruct_data_attack()
        assert (type(TAttacker.get_instance().attacker).__name__
                == type(JAttacker.get_instance().attacker).__name__)
    finally:
        TAttacker.reset()
        JAttacker.reset()


def test_fused_clip_factors_match_reference():
    rng = np.random.default_rng(4)
    flats = [{k: (rng.normal(size=sh) * s).astype(np.float32)
              for k, sh in (("w", (8, 6)), ("b", (6,)))} for s in (0.1, 1.0, 3.0, 0.5)]
    jcts = [jc.get_codec("int8").encode({k: jnp.asarray(v) for k, v in f.items()},
                                        key=jc.derive_key(0, 2, c), is_delta=True)
            for c, f in enumerate(flats)]
    tcts = [tc.get_codec("int8").encode({k: torch.from_numpy(v) for k, v in f.items()},
                                        key=tc.derive_key(0, 2, c), is_delta=True)
            for c, f in enumerate(flats)]
    args = types.SimpleNamespace(enable_defense=True, defense_type="norm_diff_clipping",
                                 norm_bound=4.0)
    JDefender.reset()
    jd, td = JDefender.get_instance(), TDefender.get_instance()
    jd.init(args)
    td.init(args)
    before = tregistry().counter("health/norm_clips_fused").value
    jbefore = jregistry().counter("health/norm_clips_fused").value
    got, want = td.fused_clip_factors(tcts), jd.fused_clip_factors(jcts)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    clipped = sum(f < 1.0 for f in want)
    assert clipped >= 2 and sum(f < 1.0 for f in got) == clipped
    assert (tregistry().counter("health/norm_clips_fused").value - before
            == jregistry().counter("health/norm_clips_fused").value - jbefore == clipped)
    assert td.is_norm_only_defense() and not td.is_fused_defense()
    assert tc.requires_full_trees(tc.get_codec("int8")) is False
    JDefender.reset()


@pytest.mark.parametrize("over,full", [
    ({}, False),
    ({"enable_defense": True, "defense_type": "krum"}, True),
    ({"enable_defense": True, "defense_type": "norm_diff_clipping"}, False),
    ({"enable_defense": True, "defense_type": "trimmed_mean"}, False),
    ({"enable_attack": True, "attack_type": "byzantine"}, True),
    ({"enable_attack": True, "attack_type": "label_flipping"}, False),
    ({"enable_dp": True, "dp_solution_type": "CDP"}, True),
    ({"enable_dp": True, "dp_solution_type": "LDP"}, False),
])
def test_requires_full_trees_is_the_reference_answer(over, full):
    from fedml_tpu.compression import requires_full_trees as jfull
    from fedml_tpu.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy as JDP

    import fedml_tpu_torch

    args = types.SimpleNamespace(random_seed=0, **over)
    fedml_tpu_torch.init(args)
    for S in (JAttacker, JDefender, JDP):
        S.reset()
        S.get_instance().init(args)
    for codec in ("int8", "topk", None):
        want = jfull(jc.get_codec(codec) if codec else None)
        got = tc.requires_full_trees(tc.get_codec(codec) if codec else None, args)
        assert got == want, codec
    assert tc.requires_full_trees(tc.get_codec("int8"), args) == full
    for S in (JAttacker, JDefender, JDP):
        S.reset()


# -- the reference's trust recipes, run on the port ---------------------------
FLIP = {"enable_attack": True, "attack_type": "byzantine", "attack_mode": "flip",
        "byzantine_client_num": 2}
RANDOM = {"enable_attack": True, "attack_type": "byzantine", "attack_mode": "random",
          "byzantine_client_num": 2}
REPLACE = {"enable_attack": True, "attack_type": "model_replacement",
           "replacement_scale": 10.0}
RECIPES = {  # examples/federate/trust/*/run.py and docs/integrity.md's settings
    "krum under attack": ({**RANDOM, "enable_defense": True, "defense_type": "krum",
                           "krum_param_k": 1}, {}, 0.85),
    "LDP": ({"enable_dp": True, "dp_solution_type": "LDP", "mechanism_type": "gaussian",
             "clipping_norm": 5.0, "epsilon": 50.0, "delta": 1e-5, "sigma": 0.05}, {}, 0.8),
    "CDP": ({"enable_dp": True, "dp_solution_type": "CDP", "mechanism_type": "gaussian",
             "clipping_norm": 5.0, "epsilon": 50.0, "delta": 1e-5, "sigma": 0.02}, {}, 0.8),
    "sweep krum": ({**FLIP, "enable_defense": True, "defense_type": "krum",
                    "krum_param_k": 1, "byzantine_client_num": 2}, {}, 0.8),
    "sweep trimmed_mean": ({**FLIP, "enable_defense": True, "defense_type": "trimmed_mean",
                            "beta": 0.34}, {}, 0.8),
    "sweep coordinate_wise_median": ({**FLIP, "enable_defense": True,
                                      "defense_type": "coordinate_wise_median"}, {}, 0.8),
    "sweep rfa": ({**FLIP, "enable_defense": True, "defense_type": "rfa"}, {}, 0.8),
    "sweep norm_diff_clipping": ({**REPLACE, "enable_defense": True,
                                  "defense_type": "norm_diff_clipping",
                                  "norm_bound": 1.0}, {}, 0.8),
    "integrity with agg_robust": ({}, {"compression": "int8", "integrity": True,
                                       "agg_robust": "trimmed_mean@0.1"}, 0.8),
}


def _recipe(security, train):
    """The examples' federation (``examples/federate/trust/_common.py``) on
    the port, through ``init`` and ``create_simulator`` as ``run_simulation``
    goes, from the reference's initial weights (the port's own init draws
    the same distributions, not the same bits)."""
    import fedml_tpu_torch
    from fedml_tpu import arguments as jarguments
    from fedml_tpu.data import data_loader as jdl
    from fedml_tpu.models import model_hub as jhub
    from fedml_tpu_torch.arguments import load_arguments_from_dict
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create
    from fedml_tpu_torch.simulation.simulator import create_simulator

    for singleton in (TAttacker, TDefender, FedMLDifferentialPrivacy, TContext):
        singleton.reset()
    cfg = {
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": "synthetic", "train_size": 1200, "test_size": 300,
                      "class_num": 6, "feature_dim": 24},
        "model_args": {"model": "mlp", "hidden_dim": 32},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 6,
                       "client_num_per_round": 6, "comm_round": 6, "epochs": 1,
                       "batch_size": 25, "learning_rate": 0.2, **train},
        "security_args": security,
    }
    jargs = jarguments.load_arguments_from_dict(cfg)
    jds = jdl.load_federated(jargs)
    init = jhub.init_params(jhub.create(jargs, jds.class_num), jargs,
                            jds.train_data_global[0][:25])
    args = fedml_tpu_torch.init(load_arguments_from_dict(cfg))
    ds = load_federated(args)
    sim = create_simulator(args, "cpu", ds, create(args, ds.class_num))
    sim.fl_trainer.global_params = from_flax_params(jax.tree.map(np.asarray, init))
    return sim.run()


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_trust_recipes_run_on_the_port(recipe):
    """The reference's trust examples and integrity recipe, on the port's
    ``run_simulation``: each trains through its attack or noise to the
    accuracy the example asserts."""
    security, train, floor = RECIPES[recipe]
    report = _recipe(security, train)
    assert report["test_acc"] > floor, report


def test_krum_out_trains_undefended_fedavg_under_attack():
    """The byzantine example's end-to-end check: undefended FedAvg is
    wrecked by two random-noise clients, krum trains through them."""
    undefended = _recipe(RANDOM, {})["test_acc"]
    defended = _recipe(RECIPES["krum under attack"][0], {})["test_acc"]
    assert defended > undefended + 0.1, (defended, undefended)


def test_cross_round_defense_matches_reference():
    """``cross_round.py``'s class, which the registry's later
    ``outlier_detection`` registration shadows in both packages, called
    directly over three rounds (its per-client direction history)."""
    from fedml_tpu.core.security.defense.cross_round import CrossRoundDefense as J
    from fedml_tpu_torch.core.security.defense.cross_round import CrossRoundDefense as T

    args = types.SimpleNamespace(cross_round_sim_threshold=0.2)
    jd, td = J(args), T(args)
    for r in range(3):
        cohort = _cohort(round_idx=r)
        if r == 2:  # client 3 turns its update around
            n3, t3 = cohort[3]
            cohort[3] = (n3, jax.tree.map(lambda a: -a, t3))
        jb, tb = jd.defend_before_aggregation(_jlist(cohort)), td.defend_before_aggregation(
            _tlist(cohort))
        assert [n for n, _ in tb] == [n for n, _ in jb]
    assert len(tb) < len(cohort)
