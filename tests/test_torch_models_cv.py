"""The port's simulation models (``fedml_tpu_torch/models``) against the
reference's flax models on the CPU: the same numpy inputs and the
reference's initial weights carried across by ``from_flax_params`` give
logits, and gradients of the mean cross-entropy, within 1e-5 (of each
tensor's largest magnitude, floored at 1). Covered: LR, CNNCifar, ResNet-18
at full width (B=2), ResNet-20, the character LSTM at hidden 32, and a
stride-2 "SAME" convolution alone (flax pads it (0, 1), not (1, 1))."""
import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from fedml_tpu.models.cv.cnn import CNNCifar as JCNNCifar
from fedml_tpu.models.cv.resnet import resnet18 as jresnet18
from fedml_tpu.models.cv.resnet import resnet20 as jresnet20
from fedml_tpu.models.linear.lr import LogisticRegression as JLR
from fedml_tpu.models.nlp.rnn import RNNOriginalFedAvg as JRNN
from fedml_tpu_torch.models import layers
from fedml_tpu_torch.models.convert import (
    from_flax_params,
    from_reference_layout,
    to_flax_params,
    to_reference_layout,
)
from fedml_tpu_torch.models.cv.cnn import CNNCifar
from fedml_tpu_torch.models.cv.resnet import resnet18, resnet20
from fedml_tpu_torch.models.linear.lr import LogisticRegression
from fedml_tpu_torch.models.nlp.rnn import RNNOriginalFedAvg
from fedml_tpu_torch.utils.tree import leaf_order

TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = tol * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= bound, f"{what}: max |err| {err:.3e} > {bound:.3e}"


def _case(name):
    rng = np.random.default_rng(0)
    if name == "lr":
        x = rng.normal(size=(4, 784)).astype(np.float32)
        y = rng.integers(0, 10, size=(4,))
        return JLR(output_dim=10), LogisticRegression(output_dim=10), x, y
    if name == "cnn_cifar":
        x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=(3,))
        return JCNNCifar(output_dim=10), CNNCifar(output_dim=10), x, y
    if name == "resnet18":
        x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=(2,))
        return jresnet18(10, 2), resnet18(10, 2), x, y
    if name == "resnet20":
        x = rng.normal(size=(3, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=(3,))
        return jresnet20(10, 2), resnet20(10, 2), x, y
    if name == "rnn":
        x = rng.integers(0, 90, size=(3, 12)).astype(np.int32)
        y = rng.integers(0, 90, size=(3, 12))
        return (JRNN(vocab_size=90, hidden_size=32),
                RNNOriginalFedAvg(vocab_size=90, hidden_size=32), x, y)
    raise KeyError(name)


@pytest.mark.parametrize("name", ["lr", "cnn_cifar", "resnet18", "resnet20", "rnn"])
def test_logits_and_gradients_match_flax(name):
    jm, tm, x, y = _case(name)
    jparams = jm.init(jax.random.key(1), jnp.asarray(x))

    def jloss(p):
        logits = jm.apply(p, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

    j_logits = np.asarray(jm.apply(jparams, jnp.asarray(x)))
    j_grads = jax.grad(jloss)(jparams)

    params = {k: v.requires_grad_() for k, v in from_flax_params(jparams).items()}
    # the port's tree has the reference's leaves, in the reference's order
    assert list(params) == ["/".join(str(p.key) for p in path) for path, _ in
                            jax.tree_util.tree_flatten_with_path(jparams)[0]]
    logits = layers.apply(tm, params, torch.from_numpy(x))
    _close(logits.detach(), j_logits, what="logits")
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           torch.from_numpy(y).long().reshape(-1))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    want = from_flax_params(j_grads)
    assert set(want) == set(grads)
    for k in want:
        _close(grads[k], want[k], what=k)


@pytest.mark.parametrize("name", ["lr", "cnn_cifar", "resnet20", "rnn"])
def test_init_has_the_reference_tree(name):
    """``init`` creates the reference's paths and (port-layout) shapes, with
    the reference's kind of values: zero biases, unit norm scales."""
    jm, tm, x, _ = _case(name)
    want = from_flax_params(jm.init(jax.random.key(0), jnp.asarray(x)))
    got = layers.init(tm, torch.from_numpy(x), seed=3)
    assert list(got) == list(want) == leaf_order(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == torch.float32, k
        if k.endswith("bias"):
            assert not got[k].any(), k
        if k.endswith("scale"):
            assert bool((got[k] == 1).all()), k
    again = layers.init(tm, torch.from_numpy(x), seed=3)
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("size,k,stride", [(32, 3, 2), (31, 3, 2), (16, 1, 2),
                                           (8, 5, 1), (9, 4, 2)])
def test_same_padding_matches_flax(size, k, stride):
    """flax's "SAME" pads (0, 1) for a 3×3 stride-2 conv on an even size,
    where torch's ``padding=1`` would pad (1, 1)."""
    conv = nn.Conv(5, (k, k), strides=(stride, stride), padding="SAME")
    x = np.random.default_rng(2).normal(size=(2, size, size, 3)).astype(np.float32)
    p = conv.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(conv.apply(p, jnp.asarray(x)))

    def model(s, t):
        return layers.conv(s, layers.nhwc_to_nchw(t), 5, (k, k), (stride, stride))

    port = from_flax_params({"params": {"Conv_0": p["params"]}})
    got = layers.apply(model, port, torch.from_numpy(x))
    _close(got.permute(0, 2, 3, 1), want, what="conv")
    if k == 3 and stride == 2 and size % 2 == 0:
        w = port["params/Conv_0/kernel"]
        symmetric = F.conv2d(layers.nhwc_to_nchw(torch.from_numpy(x)), w,
                             stride=2, padding=1)
        assert float((symmetric.permute(0, 2, 3, 1) - torch.from_numpy(want)).abs().max()) > 1e-3


def test_group_norm_matches_flax_not_torch_defaults():
    """flax's GroupNorm (epsilon 1e-6, variance E[x²] − E[x]²) on inputs of
    small variance, where torch's default epsilon 1e-5 is far off."""
    gn = nn.GroupNorm(num_groups=2)
    x = (np.random.default_rng(4).normal(size=(2, 4, 4, 6)) * 0.05 + 0.5).astype(np.float32)
    p = gn.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(gn.apply(p, jnp.asarray(x)))

    def model(s, t):
        return layers.group_norm(s, layers.nhwc_to_nchw(t), 2)

    port = from_flax_params({"params": {"GroupNorm_0": p["params"]}})
    got = layers.apply(model, port, torch.from_numpy(x))
    _close(got.permute(0, 2, 3, 1), want, tol=1e-4, what="group_norm")
    torch_default = F.group_norm(layers.nhwc_to_nchw(torch.from_numpy(x)), 2)
    assert float((torch_default.permute(0, 2, 3, 1) - torch.from_numpy(want)).abs().max()) > 1e-3


def test_round_trip_and_reference_layout_views():
    jm, _, x, _ = _case("resnet20")
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.key(0), jnp.asarray(x)))
    port = from_flax_params(jparams)
    back = to_flax_params(port)
    flat_j = jax.tree_util.tree_flatten_with_path(jparams)[0]
    flat_b = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in flat_j] == [p for p, _ in flat_b]
    for (_, a), (_, b) in zip(flat_j, flat_b):
        assert np.array_equal(a, b)
    ref = to_reference_layout(port)
    for (path, a) in flat_j:
        k = "/".join(str(p.key) for p in path)
        assert np.array_equal(ref[k].numpy(), a)
    again = from_reference_layout(ref)
    assert all(torch.equal(again[k], port[k]) and again[k].is_contiguous() for k in port)
