"""The gradient-reconstruction attacks of the port (``dlg``/``invert_gradient``
and ``revealing_labels``) beside the JAX package's, on the CPU.

DLG's dummies come from the threefry twin: the uniform words under them
are the reference's bit for bit, and ``normal`` turns them into the
reference's draws within NORMAL_TOL (``torch.erfinv`` and XLA's
``erf_inv`` round differently, the same tolerance the DP noise is held
to). Twenty DLG iterations on a small MLP then land within DLG_TOL of the
JAX package's ``DLGAttack``. ``revealing_labels`` is host numpy: identical
counts from the same gradients."""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.core.security.attack.dlg import DLGAttack as JDLG
from fedml_tpu.core.security.attack.revealing_labels import RevealingLabelsAttack as JRL
from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.core.security.attack import available_attacks, create_attacker
from fedml_tpu_torch.core.security.attack.dlg import DLGAttack
from fedml_tpu_torch.core.security.attack.revealing_labels import RevealingLabelsAttack

NORMAL_TOL = 2e-5
DLG_TOL = 1e-4
F_IN, HIDDEN, CLASSES = 8, 16, 4


def _args(**kw):
    return types.SimpleNamespace(**{"random_seed": 3, "dlg_iters": 20, "dlg_lr": 0.1, **kw})


def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.normal(size=(F_IN, HIDDEN)) * 0.5).astype(np.float32),
            "b1": (rng.normal(size=(HIDDEN,)) * 0.1).astype(np.float32),
            "w2": (rng.normal(size=(HIDDEN, CLASSES)) * 0.5).astype(np.float32),
            "b2": (rng.normal(size=(CLASSES,)) * 0.1).astype(np.float32)}


def _jax_loss_grad(params, x, y_soft):
    def loss(p):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        logp = jax.nn.log_softmax(h @ p["w2"] + p["b2"])
        return -jnp.mean(jnp.sum(y_soft * logp, -1))

    return jax.grad(loss)(params)


def _torch_loss_grad(params, x, y_soft):
    keys = sorted(params)
    h = torch.tanh(x @ params["w1"] + params["b1"])
    logp = torch.log_softmax(h @ params["w2"] + params["b2"], -1)
    loss = -torch.mean(torch.sum(y_soft * logp, -1))
    return dict(zip(keys, torch.autograd.grad(loss, [params[k] for k in keys],
                                              create_graph=True)))


def _victim(seed=1):
    """One private example, its label and the observed gradient."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, F_IN)).astype(np.float32)
    y = np.eye(CLASSES, dtype=np.float32)[[2]]
    return x, y


def test_dlg_dummies_are_the_reference_draws():
    """The dummies' uniform words are the reference's bit for bit; the
    normals within NORMAL_TOL."""
    attack = DLGAttack(_args())
    x, y = attack.dummies((2, 3, 5), 7, "cpu")
    key = jax.random.key(3 + 99991)
    kx, ky = jax.random.split(key)
    tkx, tky = threefry.split(threefry.key(3 + 99991), 2)
    for tk, jk, shape in ((tkx, kx, (2, 3, 5)), (tky, ky, (2, 7))):
        assert np.array_equal(threefry.random_bits(tk, shape).numpy().astype(np.uint32),
                              np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    np.testing.assert_allclose(x.numpy(), np.asarray(jax.random.normal(kx, (2, 3, 5))),
                               rtol=0, atol=NORMAL_TOL)
    np.testing.assert_allclose(y.numpy(), np.asarray(jax.random.normal(ky, (2, 7))),
                               rtol=0, atol=NORMAL_TOL)


@pytest.mark.parametrize("cosine", [True, False], ids=["cosine", "l2"])
def test_dlg_iterations_match_the_reference(cosine):
    """Twenty iterations of the gradient match (Adam, lr 0.1) from the same
    observed gradient: the reconstruction and its label within DLG_TOL of
    the JAX package's, and the match loss falls."""
    params = _mlp_params()
    x, y = _victim()
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    tparams = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    jgrad = _jax_loss_grad(jparams, jnp.asarray(x), jnp.asarray(y))
    tgrad = {k: g.detach() for k, g in _torch_loss_grad(
        tparams, torch.from_numpy(x), torch.from_numpy(y)).items()}
    for k in tgrad:
        np.testing.assert_allclose(tgrad[k].numpy(), np.asarray(jgrad[k]), atol=1e-6)
    args = _args(dlg_cosine=cosine)
    jx, jy = JDLG(args).reconstruct_data(jgrad, {
        "loss_grad_fn": _jax_loss_grad, "params": jparams, "x_shape": x.shape,
        "num_classes": CLASSES})
    attack = DLGAttack(args)
    tx, ty = attack.reconstruct_data(tgrad, {
        "loss_grad_fn": _torch_loss_grad, "params": tparams, "x_shape": x.shape,
        "num_classes": CLASSES})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=DLG_TOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=DLG_TOL)
    assert len(attack.losses) == 20 and float(attack.losses[-1]) < float(attack.losses[0])


def test_dlg_refuses_the_flash_attention_model():
    """A model whose forward runs the flash-attention Function has no second
    derivative (its backward is the kernels'; on the CPU their plain
    versions behind the same Function): DLG raises, naming it."""
    from fedml_tpu_torch.ops.flash_attention import flash_attention

    params = {"wq": torch.randn(8, 8, generator=torch.Generator().manual_seed(0))
              .requires_grad_(True)}

    def loss_grad_fn(p, x, y_soft):
        q = x @ p["wq"]
        loss = flash_attention(q, q, q, causal=True).sum() * y_soft.sum()
        return list(torch.autograd.grad(loss, [p["wq"]], create_graph=True))

    attack = DLGAttack(_args(dlg_iters=2))
    with pytest.raises(NotImplementedError, match="second derivative"):
        attack.reconstruct_data([torch.randn(8, 8)], {
            "loss_grad_fn": loss_grad_fn, "params": params, "x_shape": (1, 2, 4, 8),
            "num_classes": 3})


def _label_grads(seed, batch, classes, feats=6):
    """The mean bias and weight gradient of softmax cross-entropy for a
    random linear classifier at init on a labelled batch."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, feats)).astype(np.float32)
    y = rng.integers(0, classes, size=batch)
    w = (rng.normal(size=(feats, classes)) * 0.01).astype(np.float32)
    logits = x @ w
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    d = (p - np.eye(classes)[y]) / batch
    return d.sum(0), x.T @ d, np.bincount(y, minlength=classes)


@pytest.mark.parametrize("seed,batch,classes", [(0, 32, 10), (1, 8, 4), (2, 64, 10)])
def test_revealing_labels_counts_equal_the_reference(seed, batch, classes):
    """From the bias gradient and from the weight gradient (both
    orientations, as tensors): the port's counts are the reference's, and
    sum to the batch."""
    bias, weight, truth = _label_grads(seed, batch, classes)
    args = types.SimpleNamespace(random_seed=0)
    for info in ({"bias_grad": bias}, {"weight_grad": weight}, {"weight_grad": weight.T}):
        base = {"batch_size": batch, "num_classes": classes}
        want = JRL(args).reconstruct_data(None, {**base, **info})
        got = RevealingLabelsAttack(args).reconstruct_data(
            None, {**base, **{k: torch.from_numpy(np.ascontiguousarray(v))
                              for k, v in info.items()}})
        assert got == want and sum(got.values()) == batch
    got = RevealingLabelsAttack(args).reconstruct_data(
        None, {"batch_size": batch, "num_classes": classes, "bias_grad": bias})
    assert sum(abs(got[c] - int(truth[c])) for c in range(classes)) <= batch // 4


@pytest.mark.parametrize("name", ["dlg", "invert_gradient", "revealing_labels",
                                  "revealing_labels_from_gradients"])
def test_create_attacker_builds_the_reconstruction_attacks(name):
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker

    assert name in available_attacks()
    attack = create_attacker(name, _args())
    assert attack.is_reconstruct and not attack.is_data_attack
    FedMLAttacker.reset()
    try:
        FedMLAttacker.get_instance().init(_args(enable_attack=True, attack_type=name))
        assert FedMLAttacker.get_instance().is_reconstruct_data_attack()
        assert not FedMLAttacker.get_instance().is_model_attack()
    finally:
        FedMLAttacker.reset()
