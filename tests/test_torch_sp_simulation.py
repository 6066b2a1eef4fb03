"""The port's single-process FedAvg simulation against the reference's
``FedAvgAPI`` on the CPU, on the same seed: the loaders' arrays are equal,
the sampled clients are equal every round, and per round each client's train
loss and accuracy, the test loss and accuracy, and at the end the global
parameters agree — within 1e-5 for the uncompressed runs (of each value's
magnitude, floored at 1), and within one quantization step for the
compressed ones. The port starts from the reference's initial weights,
carried across by ``from_flax_params``.

The trust stack's rounds (integrity with robust aggregation and a NaN
upload, krum under a byzantine attack, norm-difference clipping with local
DP) run CNNCifar on the CIFAR-10 stand-in at 100 images, each round beside
the reference's with the singletons of both configured from the same
args."""
import builtins
import types

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import arguments as jarguments
from fedml_tpu import device as jdevice
from fedml_tpu.data import data_loader as jdl
from fedml_tpu.models import model_hub as jhub
from fedml_tpu.models.nlp.rnn import RNNOriginalFedAvg as JRNN
from fedml_tpu.simulation.sp.fedavg_api import FedAvgAPI as JFedAvgAPI
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch.data import data_loader as tdl
from fedml_tpu_torch.data.dataset import batch_epochs
from fedml_tpu_torch.models import model_hub as thub
from fedml_tpu_torch.models.convert import from_flax_params
from fedml_tpu_torch.models.nlp.rnn import RNNOriginalFedAvg
from fedml_tpu_torch.simulation.simulator import create_simulator
from fedml_tpu_torch.simulation.sp.fedavg_api import FedAvgAPI

TOL = 1e-5


def _lr_cfg(**train):
    cfg = {
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": "synthetic", "partition_method": "hetero",
                      "partition_alpha": 0.5, "train_size": 600, "test_size": 150,
                      "class_num": 5, "feature_dim": 20},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 10,
                       "client_num_per_round": 5, "comm_round": 3, "epochs": 1,
                       "batch_size": 16, "learning_rate": 0.3},
    }
    cfg["train_args"].update(train)
    return cfg


def _char_cfg(**train):
    """BASELINE config #3's shape (Shakespeare stand-in, seq 80, vocab 90,
    the character LSTM) cut to hidden 32, 60 sequences and 3 rounds."""
    cfg = {
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": "shakespeare", "train_size": 81 * 60, "seq_len": 80},
        "model_args": {"model": "rnn"},
        "train_args": {"client_num_in_total": 4, "client_num_per_round": 2,
                       "comm_round": 3, "epochs": 1, "batch_size": 8,
                       "learning_rate": 0.5},
    }
    cfg["train_args"].update(train)
    return cfg


def _record_metrics(trainer, sink):
    run = trainer.run_local_training

    def wrapped(params, data, device, args):
        w, metrics = run(params, data, device, args)
        sink.append({k: float(metrics[k]) for k in
                     ("train_loss", "train_correct", "train_samples", "local_steps")})
        return w, metrics

    trainer.run_local_training = wrapped


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


def _pair(cfg, jmodel=None, tmodel=None):
    jargs = fedml_tpu.init(jarguments.load_arguments_from_dict(cfg))
    targs = targuments.load_arguments_from_dict(cfg)
    jds, tds = jdl.load_federated(jargs), tdl.load_federated(targs)
    jm = jmodel or jhub.create(jargs, jds.class_num)
    tm = tmodel or thub.create(targs, tds.class_num)
    japi = JFedAvgAPI(jargs, jdevice.get_device(jargs), jds, jm)
    tapi = FedAvgAPI(targs, "cpu", tds, tm)
    tapi.global_params = from_flax_params(japi.global_params)
    return japi, tapi


def _run_pair(cfg, jmodel=None, tmodel=None, param_check=None):
    """Both engines side by side, round by round, from the same weights;
    ``param_check(got, want, key)`` replaces the final parameters' 1e-5."""
    japi, tapi = _pair(cfg, jmodel, tmodel)
    jm_, tm_ = [], []
    _record_metrics(japi.trainer, jm_)
    _record_metrics(tapi.trainer, tm_)
    for r in range(int(cfg["train_args"]["comm_round"])):
        jrep, trep = japi.train_one_round(r), tapi.train_one_round(r)
        assert trep["clients"] == jrep["clients"], r
        for k in ("test_loss", "test_acc"):
            _close(trep[k], jrep[k], TOL, f"round {r} {k}")
    assert len(tm_) == len(jm_)
    for i, (t, j) in enumerate(zip(tm_, jm_)):
        for k in j:
            _close(t[k], j[k], TOL, f"client update {i} {k}")
    want = from_flax_params(jax.tree.map(np.asarray, japi.global_params))
    assert list(tapi.global_params) == list(want)
    for k in want:
        (param_check or (lambda g, w, k: _close(g, w, TOL, k)))(
            tapi.global_params[k], want[k], k)
    return japi, tapi


@pytest.mark.parametrize("dataset,extra", [
    ("synthetic", {"train_size": 300, "test_size": 50, "feature_dim": 12}),
    ("synthetic_image", {"image_size": 6, "image_channels": 2}),
    ("mnist", {"train_size": 200, "test_size": 40}),
    ("cifar10", {"train_size": 120, "test_size": 30}),
    ("shakespeare", {"train_size": 81 * 20, "seq_len": 80}),
    ("synthetic", {"partition_method": "homo"}),
])
def test_loaders_give_the_reference_arrays(dataset, extra):
    cfg = {"dataset": dataset, "client_num_in_total": 4, "random_seed": 3, **extra}
    j = jdl.load_federated(types.SimpleNamespace(**cfg))
    t = tdl.load_federated(types.SimpleNamespace(**cfg))
    assert (t.train_data_num, t.test_data_num, t.class_num) == (
        j.train_data_num, j.test_data_num, j.class_num)
    assert t.train_data_local_num_dict == j.train_data_local_num_dict
    for a, b in [(t.train_data_global, j.train_data_global),
                 (t.test_data_global, j.test_data_global)] + [
            (t.train_data_local_dict[c], j.train_data_local_dict[c])
            for c in j.train_data_local_dict]:
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_batch_epochs_is_the_reference():
    from fedml_tpu.data.dataset import batch_epochs as jbatch

    rng = np.random.default_rng(0)
    x, y = rng.normal(size=(37, 3)).astype(np.float32), rng.integers(0, 5, 37)
    for kw in ({}, {"pad_to_batches": 6}, {"epochs": 2, "pad_to_batches": 4}):
        kw = {"epochs": 1, **kw}
        for a, b in zip(batch_epochs(x, y, 8, seed=11, **kw), jbatch(x, y, 8, seed=11, **kw)):
            assert np.array_equal(a, b)


def test_lr_fedavg_matches_reference():
    """LR on ``load_synthetic``: 3 rounds of 5 of 10 clients."""
    _run_pair(_lr_cfg())


def test_padded_client_with_momentum_and_weight_decay_matches_reference():
    """Hetero clients have fewer batches than the shared padding; with
    momentum 0.9 and weight decay 1e-3 a padded step still moves the
    optimizer's trace (the reference runs ``tx.update`` and zeroes the
    update), so skipping it would drift from the first padded step on."""
    cfg = _lr_cfg(momentum=0.9, weight_decay=1e-3, epochs=2)
    japi, tapi = _pair(cfg)
    sizes = tapi.dataset.train_data_local_num_dict
    pad = tapi.trainer._pad_to_batches
    assert min(-(-n // 16) for n in sizes.values()) < pad  # a padded client
    _run_pair(cfg)


def test_char_rnn_fedprox_matches_reference():
    """Config #3's FedProx on the Shakespeare stand-in with the character
    LSTM at hidden 32."""
    _run_pair(_char_cfg(federated_optimizer="FedProx", fedprox_mu=0.1),
              jmodel=JRNN(vocab_size=90, hidden_size=32),
              tmodel=RNNOriginalFedAvg(vocab_size=90, hidden_size=32))


def test_char_rnn_fedopt_adam_matches_reference():
    """Config #3's FedOpt with a server adam on the same LSTM. Client
    metrics and per-round test loss and accuracy agree within 1e-5. Adam
    divides each pseudo-gradient coordinate by its own magnitude, so where
    the aggregate barely moved (|g| near adam's 1e-8) the clients' float32
    noise — XLA's kernels against PyTorch's, ~1e-9 — becomes a visible step:
    at most 1% of the final coordinates lie beyond 1e-5 of the reference's,
    and none beyond 1e-3."""
    far = []

    def check(got, want, k):
        d = (got - want).abs()
        far.append((int((d > TOL).sum()), d.numel()))
        assert float(d.max()) <= 1e-3, (k, float(d.max()))

    _run_pair(_char_cfg(federated_optimizer="FedOpt", server_optimizer="adam",
                        server_lr=0.05),
              jmodel=JRNN(vocab_size=90, hidden_size=32),
              tmodel=RNNOriginalFedAvg(vocab_size=90, hidden_size=32),
              param_check=check)
    n_far, n = map(sum, zip(*far))
    assert n_far <= 0.01 * n, (n_far, n)


@pytest.mark.parametrize("fed_opt", ["FedNova", "SCAFFOLD", "FedDyn", "Mime"])
def test_other_optimizers_match_reference(fed_opt):
    cfg = _lr_cfg(federated_optimizer=fed_opt, comm_round=2, momentum=0.5)
    _run_pair(cfg)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_compressed_uplinks_match_reference(codec):
    """int8 and topk uplinks with error feedback. The wire is the
    reference's: the same keys over the same layout draw the same noise, so
    the runs differ only where a client's float update differs by ulps from
    the reference's next to a rounding or top-k boundary — by at most one
    quantization step of that leaf (its largest update / 127 for int8; the
    largest dropped entry for topk, which error feedback re-sends)."""
    cfg = _lr_cfg(compression=codec, compression_topk_ratio=0.3)
    japi, tapi = _pair(cfg)
    steps = {}
    for r in range(3):
        g0 = {k: v.clone() for k, v in tapi.global_params.items()}
        jrep, trep = japi.train_one_round(r), tapi.train_one_round(r)
        assert trep["clients"] == jrep["clients"]
        for k, v in tapi.global_params.items():
            steps[k] = max(steps.get(k, 0.0), float((v - g0[k]).abs().max()) / 127
                           if codec == "int8" else float((v - g0[k]).abs().max()))
        want = from_flax_params(jax.tree.map(np.asarray, japi.global_params))
        for k in want:
            err = float((tapi.global_params[k] - want[k]).abs().max())
            assert err <= max(steps[k], 1e-6), (r, k, err, steps[k])
        for key in ("test_loss", "test_acc"):
            assert abs(trep[key] - jrep[key]) <= 1e-2, (r, key)
    assert trep["uplink_bytes"] and all(b > 0 for b in trep["uplink_bytes"])


def test_run_simulation_on_cpu_and_cuda_refusal():
    args = targuments.load_arguments_from_dict(_lr_cfg(comm_round=2))
    report = fedml_tpu_torch.run_simulation(args, device="cpu")
    assert report["rounds"] == 2 and 0.0 <= report["test_acc"] <= 1.0
    assert np.isfinite(report["test_loss"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fedml_tpu_torch.run_simulation(args)


def test_unported_options_raise_naming_their_item(tmp_path):
    """The parts still to port raise naming their item; the trust stack's
    ported parts build (robust aggregation without a codec is refused as
    the reference refuses it)."""
    base = _lr_cfg()
    tds = tdl.load_federated(targuments.load_arguments_from_dict(base))
    for train in ({"enable_dp": True}, {"integrity": True},
                  {"enable_defense": True, "defense_type": "krum"}):
        targs = targuments.load_arguments_from_dict(_lr_cfg(**train))
        create_simulator(targs, "cpu", tds, thub.create(targs, tds.class_num))
    targs = targuments.load_arguments_from_dict(_lr_cfg(agg_robust="median"))
    with pytest.raises(ValueError, match="agg_robust rides the compressed"):
        create_simulator(targs, "cpu", tds, thub.create(targs, tds.class_num))
    # contribution assessment and round checkpoints are ported: they build
    for train in ({"enable_contribution": True},
                  {"checkpoint_dir": str(tmp_path / "ck"), "resume": True}):
        targs = targuments.load_arguments_from_dict(_lr_cfg(**train))
        create_simulator(targs, "cpu", tds, thub.create(targs, tds.class_num))
    for train, item in [({"enable_fhe": True}, "A13"), ({"trace_rounds": [1]}, "A12"),
                        ({"backend": "mesh"}, "A11"),
                        ({"federated_optimizer": "fedgkt"}, "A13")]:
        cfg = _lr_cfg(**train)
        targs = targuments.load_arguments_from_dict(cfg)
        with pytest.raises(NotImplementedError, match=item):
            create_simulator(targs, "cpu", tds, thub.create(targs, tds.class_num))
    with pytest.raises(NotImplementedError, match="A13"):
        thub.create(types.SimpleNamespace(model="vgg11"), 10)


# -- the trust stack in the sp engine ----------------------------------------
@pytest.fixture
def reset_trust():
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    yield
    for singleton in (FedMLAttacker, FedMLDefender, FedMLDifferentialPrivacy):
        singleton.reset()


# CNNCifar's convolutions round differently in XLA and PyTorch (~1e-6 a
# step); over a few local steps a round the uncompressed parameters and
# metrics agree within 1e-4 of their magnitude (floored at 1)
CNN_TOL = 1e-4

# The CIFAR-10 stand-in's images come from ``random_seed + hash("cifar10") %
# 1000`` in both loaders, and ``hash`` is salted per process, so each pytest
# worker drew its own data. The _cnn_cfg tests pin that term to CIFAR_DRAW in
# both loaders, so every run trains on the same images: on it the robust-
# median rounds' worst leaf sits at 0.25 of its accumulated bound. Some
# draws end past it (2 of 31 measured on an x86 host with AVX-512); on
# FAILING_DRAW a round-2 leaf ends 1.07 of it apart (with the loss,
# accuracy, cohorts and counters equal): the bound assumes a round adds at
# most one quantization step to the disagreement, but local SGD from two
# models a step apart can carry the old disagreement forward grown. That
# draw is held as its own case, each round from the same weights.
CIFAR_DRAW = 1
FAILING_DRAW = 4


@pytest.fixture
def cifar_draw(monkeypatch):
    """``pin(v)``: both loaders draw the stand-in from ``random_seed + v``."""
    def pin(v):
        def pinned(name):
            return v if name == "cifar10" else builtins.hash(name)

        for loader in (jdl, tdl):
            monkeypatch.setattr(loader, "hash", pinned, raising=False)

    pin(CIFAR_DRAW)
    return pin


def _cnn_cfg(partition="hetero", **train):
    cfg = {
        "common_args": {"training_type": "simulation", "random_seed": 0},
        "data_args": {"dataset": "cifar10", "train_size": 100, "test_size": 20,
                      "partition_method": partition},
        "model_args": {"model": "cnn"},
        "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 5,
                       "client_num_per_round": 5, "comm_round": 3, "epochs": 1,
                       "batch_size": 20, "learning_rate": 0.05},
    }
    cfg["train_args"].update(train)
    return cfg


def _trust_pair(cfg):
    japi, tapi = _pair(cfg)
    fedml_tpu_torch.init(tapi.args)
    return japi, tapi


class _CorruptingEF:
    """A client's error feedback whose next upload arrives with its first
    scale NaN (the reference's ``corrupt_model_payload``), on either side."""

    def __init__(self, inner, corrupt):
        self._inner, self._corrupt = inner, corrupt

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def encode(self, tree, key=None):
        return self._corrupt(self._inner.encode(tree, key=key))


def _record_steps(monkeypatch):
    """Each leaf's quantization steps so far: every fused aggregation adds
    the largest int8 scale among its uploads (one step of the coarsest
    client; a round's flipped codes move the aggregate by at most that, and
    the next round starts from the moved model)."""
    from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator

    steps = {}
    agg = FedMLAggOperator.agg_compressed

    def recording(args, raw_list, global_params, **kw):
        for j, key in enumerate(raw_list[0][1].structure):
            scales = [float(ct.arrays[j][1]) for _, ct in raw_list
                      if len(ct.arrays[j]) == 2]
            steps[key] = steps.get(key, 0.0) + max(scales, default=0.0)
        return agg(args, raw_list, global_params, **kw)

    monkeypatch.setattr(FedMLAggOperator, "agg_compressed", staticmethod(recording))
    return steps


def _hold_round(r, tapi, japi, trep, jrep, steps=None, noise=0.0):
    """The same clients; each leaf within its accumulated quantization
    steps, widened by the scales' own drift — a client's scale moves with
    its float32 training, up to CNN_TOL of it, and a code of up to 127
    carries that 127-fold — plus ``noise`` (quantized: ``steps`` given), or
    CNN_TOL uncompressed; the test loss within 1e-2 (quantized) or CNN_TOL,
    and the test accuracy within two of the 20 test images (quantized: a
    step's difference can move an image that sits on a decision boundary)
    or CNN_TOL."""
    quant = steps is not None
    assert trep["clients"] == jrep["clients"], r
    want = from_flax_params(jax.tree.map(np.asarray, japi.global_params))
    for k, v in tapi.global_params.items():
        err = float((v - want[k]).abs().max())
        if quant:
            bound = max(steps[k], 1e-6) * (1.0 + 127 * CNN_TOL) + noise
            assert err <= bound, (r, k, err, steps[k])
        else:
            _close(v, want[k], CNN_TOL, f"round {r} {k}")
    for key, quant_tol in (("test_loss", 1e-2), ("test_acc", 2.0 / jrep["test_total"])):
        tol = quant_tol if quant else CNN_TOL * max(1.0, abs(jrep[key]))
        assert abs(trep[key] - jrep[key]) <= tol, (r, key, trep[key], jrep[key])


def _robust_median_rounds(monkeypatch, resync=False):
    """int8 uplinks, ``integrity: true``, ``agg_robust: median``; client 2's
    round-1 upload arrives with a NaN scale: both engines screen it,
    quarantine client 2 out of round 2, and aggregate the rest with the
    fused median. The partition is IID: on the hetero one the z pass also
    drops honest clients whose bias leaves stand out (in both engines
    alike), which would leave round 1 without client 2. With ``resync``
    each round starts the port from the reference's global model, and each
    leaf is held to that round's own quantization steps."""
    from fedml_tpu.resilience.chaos import corrupt_model_payload
    from fedml_tpu.telemetry import get_registry as jreg
    from fedml_tpu_torch.resilience import corrupt_model_payload as port_corrupt
    from fedml_tpu_torch.telemetry import get_registry as treg

    names = ("integrity/nonfinite_uploads", "integrity/quarantined")
    japi, tapi = _trust_pair(_cnn_cfg("homo", compression="int8", integrity=True,
                                      agg_robust="median"))
    assert tapi._agg_robust == japi._agg_robust == "median"
    tb = {n: treg().counter(n).value for n in names}
    jb = {n: jreg().counter(n).value for n in names}
    steps = _record_steps(monkeypatch)
    for r in range(3):
        if r == 1:
            japi._ef_by_client[2] = _CorruptingEF(
                japi._ef_by_client[2], lambda ct: corrupt_model_payload(ct, "nan"))
            tapi._ef_by_client[2] = _CorruptingEF(
                tapi._ef_by_client[2], lambda ct: port_corrupt(ct, "nan"))
        before = dict(steps)
        if resync:
            tapi.global_params = from_flax_params(jax.tree.map(np.asarray,
                                                               japi.global_params))
        jrep, trep = japi.train_one_round(r), tapi.train_one_round(r)
        round_steps = ({k: v - before.get(k, 0.0) for k, v in steps.items()}
                       if resync else steps)
        _hold_round(r, tapi, japi, trep, jrep, round_steps)
    assert trep["clients"] == [0, 1, 3, 4]  # client 2 sat out round 2
    for n in names:
        assert treg().counter(n).value - tb[n] == jreg().counter(n).value - jb[n] == 1
    assert tapi._quarantine.reason(2) == japi._quarantine.reason(2)


def test_integrity_with_robust_median_matches_reference(reset_trust, monkeypatch, cifar_draw):
    """The robust-median rounds (``_robust_median_rounds``) on the pinned
    draw, the two engines' models evolving side by side."""
    _robust_median_rounds(monkeypatch)


def test_integrity_with_robust_median_on_the_failing_draw(reset_trust, monkeypatch,
                                                          cifar_draw):
    """FAILING_DRAW, where the side-by-side models drift past the
    accumulated bound by round 2 (see CIFAR_DRAW): from the same weights
    each round, both engines screen the same upload, quarantine the same
    client, sample the same cohorts, count the same, and agree within that
    round's own quantization steps, loss and accuracy."""
    cifar_draw(FAILING_DRAW)
    _robust_median_rounds(monkeypatch, resync=True)


def test_krum_under_a_byzantine_attack_matches_reference(reset_trust, cifar_draw):
    """Uncompressed: the attack replaces client 0's model with N(0, 1) noise;
    krum keeps one benign model a round, the same one as the reference."""
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    japi, tapi = _trust_pair(_cnn_cfg(
        enable_attack=True, attack_type="byzantine", byzantine_client_num=1,
        attack_mode="random", enable_defense=True, defense_type="krum"))
    defender = FedMLDefender.get_instance()
    kept = []
    before = defender.defend_before_aggregation

    def recording(raw_client_grad_list, extra_auxiliary_info=None):
        out = before(raw_client_grad_list, extra_auxiliary_info)
        kept.append([next(i for i, p in enumerate(raw_client_grad_list) if p is o)
                     for o in out])
        return out

    defender.defend_before_aggregation = recording
    for r in range(3):
        jrep, trep = japi.train_one_round(r), tapi.train_one_round(r)
        _hold_round(r, tapi, japi, trep, jrep)
    assert len(kept) == 3 and all(len(k) == 1 and k[0] != 0 for k in kept), kept


def test_norm_clipping_with_local_dp_matches_reference(reset_trust, monkeypatch, cifar_draw):
    """int8 uplinks under norm-difference clipping (the fused clip factors)
    and local DP (each client clips and noises its model): the same rounds,
    within one quantization step plus the noise bound, and the same clip
    count."""
    from fedml_tpu.telemetry import get_registry as jreg
    from fedml_tpu_torch.compression import requires_full_trees
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )
    from fedml_tpu_torch.telemetry import get_registry as treg

    japi, tapi = _trust_pair(_cnn_cfg(
        compression="int8", enable_defense=True, defense_type="norm_diff_clipping",
        norm_bound=0.5, enable_dp=True, dp_solution_type="LDP", epsilon=50.0,
        clipping_norm=20.0))
    assert requires_full_trees(tapi._codec, tapi.args) is False
    sigma = FedMLDifferentialPrivacy.get_instance().frame.mechanism.sigma
    name = "health/norm_clips_fused"
    tb, jb = treg().counter(name).value, jreg().counter(name).value
    steps = _record_steps(monkeypatch)
    for r in range(3):
        jrep, trep = japi.train_one_round(r), tapi.train_one_round(r)
        _hold_round(r, tapi, japi, trep, jrep, steps, noise=2e-5 * sigma)
    clips = treg().counter(name).value - tb
    assert clips == jreg().counter(name).value - jb > 0
    assert FedMLDifferentialPrivacy.get_instance().epsilon_spent() > 0


class _PoisonTrainer:
    """Wraps a trainer; client ``cid``'s model from round ``rnd`` on becomes
    ``fn(global, model)`` (either package's trees)."""

    def __init__(self, inner, cid, rnd, fn):
        self._inner, self._pc, self._pr, self._fn = inner, cid, rnd, fn
        self._cid = self._rnd = None

    def __getattr__(self, k):
        return getattr(self._inner, k)

    def set_id(self, cid):
        self._cid = cid
        self._inner.set_id(cid)

    def set_round(self, r):
        self._rnd = r
        self._inner.set_round(r)

    def run_local_training(self, params, data, device, args):
        w, m = self._inner.run_local_training(params, data, device, args)
        if self._cid == self._pc and self._rnd >= self._pr:
            w = self._fn(params, w)
        return w, m


def _poison_pair(cfg, cid, rnd, jfn, tfn):
    japi, tapi = _trust_pair(cfg)
    japi.trainer = _PoisonTrainer(japi.trainer, cid, rnd, jfn)
    tapi.trainer = _PoisonTrainer(tapi.trainer, cid, rnd, tfn)
    return japi, tapi


def _lr_integrity_cfg(**train):
    return _lr_cfg(**{"client_num_in_total": 5, "client_num_per_round": 5,
                      "comm_round": 5, **train})


def test_rollback_and_quarantine_match_reference(reset_trust):
    """Ring 3 (identity uplinks, the screens opened): client 3's round-2
    model is pushed 200× away from the global, the eval loss spikes, and
    both engines roll the round back, quarantine client 3 and re-run it —
    the same reports round by round, parameters within TOL."""
    cfg = _lr_integrity_cfg(compression="identity", integrity=True,
                            integrity_norm_mult=1e9, integrity_z_threshold=1e9)
    japi, tapi = _poison_pair(
        cfg, 3, 2, lambda g, w: jax.tree.map(lambda gg, xx: gg + 200.0 * (gg - xx), g, w),
        lambda g, w: {k: g[k] + 200.0 * (g[k] - w[k]) for k in w})
    r = 0
    while r < 5:
        jrep, trep = japi.train_one_round(r), tapi.train_one_round(r)
        assert trep["clients"] == jrep["clients"]
        assert trep.get("rolled_back") == jrep.get("rolled_back")
        if not jrep.get("rolled_back"):
            for k in ("test_loss", "test_acc"):
                _close(trep[k], jrep[k], TOL, f"round {r} {k}")
            r += 1
    assert tapi._guard.total_rollbacks == japi._guard.total_rollbacks == 1
    assert "rolled back" in tapi._quarantine.reason(3)
    want = from_flax_params(jax.tree.map(np.asarray, japi.global_params))
    for k in want:
        _close(tapi.global_params[k], want[k], TOL, k)


def test_rollback_budget_aborts_like_reference(reset_trust):
    """Ring 3 alone: a NaN model from round 1 on cannot be pinned on anyone
    (no screen), so the round is rolled back until the budget is spent, and
    both engines raise on the same round."""
    from fedml_tpu.integrity import RollbackBudgetExceeded as JBudget
    from fedml_tpu_torch.integrity import RollbackBudgetExceeded

    cfg = _lr_integrity_cfg(compression="identity", integrity_rollback=True,
                            max_rollbacks=1)
    japi, tapi = _poison_pair(
        cfg, 1, 1, lambda g, w: jax.tree.map(lambda x: x * np.float32("nan"), w),
        lambda g, w: {k: v * float("nan") for k, v in w.items()})
    with pytest.raises(JBudget):
        japi.train()
    with pytest.raises(RollbackBudgetExceeded):
        tapi.train()
    assert tapi._guard.total_rollbacks == japi._guard.total_rollbacks == 2


def test_uncompressed_screen_matches_reference(reset_trust):
    """Ring 1 without a codec: the raw displacement is screened against the
    global; client 2's 200× model is dropped (the z pass at round 0, the
    norm overflow later) and quarantined, in both engines alike."""
    cfg = _lr_integrity_cfg(integrity=True, comm_round=4)
    japi, tapi = _poison_pair(cfg, 2, 0, lambda g, w: jax.tree.map(lambda x: x * 200.0, w),
                              lambda g, w: {k: v * 200.0 for k, v in w.items()})
    for r in range(4):
        jrep, trep = japi.train_one_round(r), tapi.train_one_round(r)
        assert trep["clients"] == jrep["clients"]
        for k in ("test_loss", "test_acc"):
            _close(trep[k], jrep[k], TOL, f"round {r} {k}")
    assert tapi._quarantine.reason(2) is not None
    assert tapi._quarantine.reason(2) == japi._quarantine.reason(2)
