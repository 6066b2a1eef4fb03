"""The port's single-process FedAvg simulation against the reference's
``FedAvgAPI`` on the CPU, on the same seed: the loaders' arrays are equal,
the sampled clients are equal every round, and per round each client's train
loss and accuracy, the test loss and accuracy, and at the end the global
parameters agree — within 1e-5 for the uncompressed runs (of each value's
magnitude, floored at 1), and within one quantization step for the
compressed ones. The port starts from the reference's initial weights,
carried across by ``from_flax_params``."""
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


def test_unported_options_raise_naming_their_item():
    base = _lr_cfg()
    tds = tdl.load_federated(targuments.load_arguments_from_dict(base))
    for train, item in [({"enable_dp": True}, "A10"), ({"integrity": True}, "A10"),
                        ({"agg_robust": "median"}, "A10"),
                        ({"enable_contribution": True}, "A10"),
                        ({"checkpoint_dir": "/x"}, "A4"), ({"trace_rounds": [1]}, "A12"),
                        ({"backend": "mesh"}, "A11"),
                        ({"federated_optimizer": "fedgkt"}, "A13")]:
        cfg = _lr_cfg(**train)
        targs = targuments.load_arguments_from_dict(cfg)
        with pytest.raises(NotImplementedError, match=item):
            create_simulator(targs, "cpu", tds, thub.create(targs, tds.class_num))
    with pytest.raises(NotImplementedError, match="A13"):
        thub.create(types.SimpleNamespace(model="vgg11"), 10)
