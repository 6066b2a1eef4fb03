"""The port's differential privacy (``fedml_tpu_torch/core/dp``) against the
reference's (``fedml_tpu/core/dp``) on the CPU:

* the threefry twin's ``split`` and ``fold_in`` give JAX's key data bit for
  bit;
* Gaussian and Laplace noise: the uniform under them is bit-equal, and
  ``torch.erfinv`` / ``torch.log1p`` differ from XLA's polynomials by a few
  ulp, so each noised element is within ``2e-5·σ`` (σ the noise scale) plus
  one f32 ulp of its magnitude of the reference's — leaf by leaf in the
  reference's layout (a conv kernel is drawn HWIO and carried to OIHW);
* ``clip_update`` within 1e-6 relative; the RDP accountant's ε within
  1e-9;
* the LDP, CDP and NbAFL frames through the singletons, with the release
  counter, ``take_key_data`` and the budget refusal; and a silo's stream
  draws what a fresh process's singleton would.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.core.dp import budget_accountant as jacc
from fedml_tpu.core.dp.fedml_differential_privacy import (
    FedMLDifferentialPrivacy as JDP,
)
from fedml_tpu.core.dp.frames.dp_clip import clip_update as jclip
from fedml_tpu.core.dp.mechanisms import add_gaussian_noise as jgauss
from fedml_tpu.core.dp.mechanisms import add_laplace_noise as jlaplace
from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.core.dp import budget_accountant as tacc
from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
    FedMLDifferentialPrivacy as TDP,
)
from fedml_tpu_torch.core.dp.frames.dp_clip import clip_update as tclip
from fedml_tpu_torch.core.dp.mechanisms import add_gaussian_noise as tgauss
from fedml_tpu_torch.core.dp.mechanisms import add_laplace_noise as tlaplace
from fedml_tpu_torch.core.security.attacker import FedMLAttacker
from fedml_tpu_torch.core.security.defender import FedMLDefender
from fedml_tpu_torch.models.convert import from_flax_params

NOISE_TOL = 2e-5  # of the noise scale


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    yield
    FedMLAttacker.reset()
    FedMLDefender.reset()
    TDP.reset()


def _flax_tree(seed=0):
    """A nested reference tree: a conv kernel (HWIO), a dense kernel, a bias."""
    rng = np.random.default_rng(seed)
    return {"params": {
        "Conv_0": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                   "bias": rng.normal(size=(4,)).astype(np.float32)},
        "Dense_0": {"kernel": rng.normal(size=(7, 5)).astype(np.float32)}}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _hold_noise(got, want, scale):
    want = from_flax_params(jax.tree.map(np.asarray, want))
    for k in want:
        w = want[k].numpy()
        err = np.abs(got[k].numpy() - w)
        bound = NOISE_TOL * scale + np.spacing(np.abs(w).astype(np.float32))
        assert np.all(err <= bound), (k, float(err.max()))


@pytest.mark.parametrize("seed,counter", [(0, 1), (7919, 3), (2 ** 31 - 1, 10 ** 6)])
def test_key_data_fold_in_and_split_are_bit_exact(seed, counter):
    jk = jax.random.fold_in(jax.random.key(seed), counter)
    tk = threefry.fold_in(threefry.key(seed), counter)
    assert np.array_equal(threefry.key_data(tk), np.asarray(jax.random.key_data(jk)))
    for n in (1, 3, 62):
        assert np.array_equal(threefry.split(tk, n).numpy().astype(np.uint32),
                              np.asarray(jax.random.key_data(jax.random.split(jk, n))))


@pytest.mark.parametrize("shape", [(5,), (3, 7), (4, 3, 2, 9), (20000,)])
def test_normal_and_laplace_draws_match_reference(shape):
    k = threefry.fold_in(threefry.key(11), 2)
    jk = jax.random.fold_in(jax.random.key(11), 2)
    for tdraw, jdraw in ((threefry.normal, jax.random.normal),
                         (threefry.laplace, jax.random.laplace)):
        got = tdraw(k, shape).numpy()
        want = np.asarray(jdraw(jk, shape, jnp.float32))
        assert got.dtype == want.dtype == np.float32
        assert float(np.abs(got - want).max()) <= NOISE_TOL, tdraw.__name__


@pytest.mark.parametrize("sigma", [0.01, 1.0, 3.5])
def test_gaussian_and_laplace_noise_on_a_tree(sigma):
    tree = _flax_tree()
    port = from_flax_params(tree)
    jk = jax.random.fold_in(jax.random.key(7919), 4)
    tk = threefry.fold_in(threefry.key(7919), 4)
    _hold_noise(tgauss(port, tk, sigma), jgauss(_jax(tree), jk, sigma), sigma)
    _hold_noise(tlaplace(port, tk, sigma), jlaplace(_jax(tree), jk, sigma), sigma)


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 1e6])
def test_clip_update_matches_reference(max_norm):
    tree = _flax_tree(3)
    got = tclip(from_flax_params(tree), max_norm)
    want = from_flax_params(jax.tree.map(np.asarray, jclip(_jax(tree), max_norm)))
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("eps,delta,steps", [(1.0, 1e-5, 1), (8.0, 1e-6, 37),
                                             (50.0, 1e-5, 500)])
def test_rdp_accountant_epsilon_matches_reference(eps, delta, steps):
    args = types.SimpleNamespace(epsilon=eps, delta=delta, sensitivity=1.0)
    ja, ta = jacc.BudgetAccountant(args), tacc.BudgetAccountant(args)
    assert ta.noise_multiplier == ja.noise_multiplier
    ja.record_release(steps)
    ta.record_release(steps)
    assert abs(ta.epsilon_spent() - ja.epsilon_spent()) <= 1e-9


def _dp_args(solution, **kw):
    return types.SimpleNamespace(enable_dp=True, dp_solution_type=solution,
                                 random_seed=3, epsilon=20.0, delta=1e-5,
                                 sensitivity=1.0, **kw)


@pytest.mark.parametrize("solution,mechanism", [("LDP", "gaussian"), ("CDP", "gaussian"),
                                                ("NbAFL", "gaussian"), ("LDP", "laplace")])
def test_dp_frames_through_the_singletons(solution, mechanism):
    args = _dp_args(solution, mechanism_type=mechanism, clipping_norm=2.0)
    JDP.reset()
    jdp, tdp = JDP.get_instance(), TDP.get_instance()
    jdp.init(args)
    tdp.init(args)
    for pred in ("is_local_dp_enabled", "is_global_dp_enabled", "is_clipping"):
        assert getattr(tdp, pred)() == getattr(jdp, pred)()
    scale = (tdp.frame.mechanism.sigma if mechanism == "gaussian"
             else tdp.frame.mechanism.scale)
    tree = _flax_tree(5)
    for _ in range(2):  # the counter advances one release a call
        _hold_noise(tdp.add_local_noise(from_flax_params(tree)),
                    jdp.add_local_noise(_jax(tree)), scale)
        _hold_noise(tdp.add_global_noise(from_flax_params(tree)),
                    jdp.add_global_noise(_jax(tree)), scale)
    assert abs(tdp.epsilon_spent() - jdp.epsilon_spent()) <= 1e-9
    assert np.array_equal(tdp.take_key_data(3), jdp.take_key_data(3))
    clipped = tdp.global_clip([(4, from_flax_params(tree))])
    want = jdp.global_clip([(4, _jax(tree))])
    assert clipped[0][0] == want[0][0]
    for k, v in from_flax_params(jax.tree.map(np.asarray, want[0][1])).items():
        np.testing.assert_allclose(clipped[0][1][k].numpy(), v.numpy(), rtol=1e-6)
    JDP.reset()


def test_budget_refusal_matches_reference():
    args = _dp_args("LDP", max_epsilon=40.0)
    JDP.reset()
    jdp, tdp = JDP.get_instance(), TDP.get_instance()
    jdp.init(args)
    tdp.init(args)
    tree = _flax_tree()
    done = []
    for dp, t in ((jdp, _jax(tree)), (tdp, from_flax_params(tree))):
        n = 0
        with pytest.raises(RuntimeError, match="max_epsilon"):
            for n in range(1000):
                dp.add_local_noise(t)
        done.append(n)
    assert done[0] == done[1] > 0
    JDP.reset()


def test_a_stream_draws_what_a_fresh_process_would():
    """In-process silos: stream 2's releases are a fresh singleton's, however
    the other streams interleave."""
    args = _dp_args("LDP")
    tdp = TDP.get_instance()
    tdp.init(args)
    tree = from_flax_params(_flax_tree())
    tdp.add_local_noise(tree, stream=1)
    a = tdp.add_local_noise(tree, stream=2)
    tdp.add_local_noise(tree)
    b = tdp.add_local_noise(tree, stream=2)
    JDP.reset()
    jdp = JDP.get_instance()
    jdp.init(args)
    jt = _jax(_flax_tree())
    _hold_noise(a, jdp.add_local_noise(jt), tdp.frame.mechanism.sigma)
    _hold_noise(b, jdp.add_local_noise(jt), tdp.frame.mechanism.sigma)
    assert tdp.epsilon_spent(stream=2) == pytest.approx(jdp.epsilon_spent(), abs=1e-9)
    JDP.reset()
