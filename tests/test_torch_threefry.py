"""The port's threefry twin (``fedml_tpu_torch/compression/threefry.py``)
against ``jax.random`` on the CPU, bit for bit: key data, ``fold_in``
chains, 32-bit draws and float32 uniforms, over seeds 0 and 2^31-1, round
and client ids up to 10^4, 0-d and odd shapes, and a shape of more than
2^16 elements."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fedml_tpu.compression import derive_key as jax_derive_key
from fedml_tpu_torch.compression import derive_key, threefry

SEEDS = [0, 1, 2 ** 31 - 1, -3, 2 ** 32 + 5]
SHAPES = [(), (1,), (2,), (3,), (5, 7), (3, 1, 5), (2, 3, 4, 5), (257, 257)]


def _jdata(k):
    return np.asarray(jax.random.key_data(k))


def _u32(a):
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data(seed):
    got = threefry.key_data(threefry.key(seed))
    assert got.dtype == np.uint32
    assert np.array_equal(got, _jdata(jax.random.key(seed)))


@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1])
def test_fold_in_chains(seed):
    jk, tk = jax.random.key(seed), threefry.key(seed)
    for d in [0, 1, 2, 17, 999, 10 ** 4, 2 ** 31 - 1, 2 ** 32 - 1]:
        jk, tk = jax.random.fold_in(jk, d), threefry.fold_in(tk, d)
        assert np.array_equal(threefry.key_data(tk), _jdata(jk)), d


@pytest.mark.parametrize("round_idx", [0, 1, 37, 10 ** 4])
@pytest.mark.parametrize("client_id", [0, 9, 10 ** 4])
@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1])
def test_derive_key(seed, round_idx, client_id):
    assert np.array_equal(threefry.key_data(derive_key(seed, round_idx, client_id)),
                          _jdata(jax_derive_key(seed, round_idx, client_id)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", [0, 2 ** 31 - 1])
def test_bits_and_uniform(shape, seed):
    jk = jax.random.fold_in(jax.random.key(seed), 5)
    tk = threefry.fold_in(threefry.key(seed), 5)
    bits = threefry.random_bits(tk, shape)
    assert tuple(bits.shape) == shape
    assert np.array_equal(bits.numpy().astype(np.uint32),
                          np.asarray(jax.random.bits(jk, shape, jnp.uint32)))
    u = threefry.uniform(tk, shape)
    want = jax.random.uniform(jk, shape)
    assert tuple(u.shape) == shape and str(u.dtype) == "torch.float32"
    assert np.array_equal(_u32(u.numpy()), _u32(want))
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


def test_uniform_inside_jit_and_over_two_to_the_sixteen():
    """The reference draws inside jitted programs; a jitted draw has the
    same bits, and so has a draw of more than 2^16 elements."""
    shape = (3, 2 ** 16 + 11)
    jk = jax_derive_key(7, 3, 2)
    want = jax.jit(lambda k: jax.random.uniform(k, shape))(jk)
    got = threefry.uniform(derive_key(7, 3, 2), shape)
    assert np.array_equal(_u32(got.numpy()), _u32(want))


def test_leaf_keys_fold_in_the_leaf_index():
    jk, tk = jax_derive_key(1, 2, 3), derive_key(1, 2, 3)
    for i in range(40):
        assert np.array_equal(threefry.key_data(threefry.fold_in(tk, i)),
                              _jdata(jax.random.fold_in(jk, i)))
