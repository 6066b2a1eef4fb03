"""The port's wire codecs (``fedml_tpu_torch/compression``) against the
reference's on the CPU: for the same leaves and the same
``derive_key``, every codec's wire arrays (codes, scales, indices, packed
nibbles) are byte-identical, decode gives equal trees, the dequant-fused
weighted sum agrees within 1e-6 of the reference's, error-feedback residuals
agree over 3 rounds, and the same malformed inputs are refused."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import compression as jc
from fedml_tpu.compression import codecs as jcodecs
from fedml_tpu_torch import compression as tc
from fedml_tpu_torch.compression import codecs as tcodecs
from fedml_tpu_torch.utils.tree import leaf_order

CODECS = ["identity", "bf16", "int8", "topk", "int4", "nf4", "topk@0.3",
          "int4@32", "nf4@16"]


def _leaves(seed=0, zeros=False):
    """Path → numpy leaf: conv/dense/bias shapes, a 0-d leaf, odd sizes, an
    all-zero leaf, an int counter, and (``zeros``) many exact-zero deltas —
    top-k ties — as MNIST's constant border pixels give LR."""
    rng = np.random.default_rng(seed)
    out = {
        "params/Conv_0/kernel": rng.normal(size=(3, 3, 3, 8)),
        "params/Dense_0/bias": rng.normal(size=(10,)) * 1e-3,
        "params/Dense_0/kernel": rng.normal(size=(37, 10)),
        "params/GroupNorm_0/scale": 1.0 + rng.normal(size=(8,)) * 0.1,
        "params/odd": rng.normal(size=(5, 7, 3)),
        "params/scalar": np.asarray(rng.normal()),
        "params/zero": np.zeros((4, 6)),
        "step": np.asarray(7, np.int32),
    }
    out = {k: v.astype(np.float32) if v.dtype != np.int32 else v
           for k, v in out.items()}
    if zeros:
        w = out["params/Dense_0/kernel"]
        w[:30] = 0.0  # 300 of 370 exact zeros: top-k draws from the ties
        out["params/odd"][:, :5] = 0.0
    return out


def _jax_tree(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        keys = path.split("/")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = jnp.asarray(v)
    return tree


def _port_tree(flat):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def _jax_paths(tree):
    return ["/".join(str(p.key) for p in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _np(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(jnp.bfloat16)
        return a.numpy()
    return np.asarray(a)


def _same_bytes(got, want):
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype and got.shape == want.shape, (
        got.dtype, want.dtype, got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


def _same_wire(ct_t, ct_j):
    assert ct_t.codec == ct_j.codec and ct_t.version == ct_j.version
    assert ct_t.is_delta == ct_j.is_delta and ct_t.raw_nbytes == ct_j.raw_nbytes
    assert ct_t.meta == ct_j.meta
    assert len(ct_t.arrays) == len(ct_j.arrays)
    for parts_t, parts_j in zip(ct_t.arrays, ct_j.arrays):
        assert len(parts_t) == len(parts_j)
        for a, b in zip(parts_t, parts_j):
            _same_bytes(a, b)


def test_leaf_order_is_the_reference_flatten_order():
    flat = _leaves()
    flat["params/a-b/x"] = np.zeros(2, np.float32)  # '-' sorts below '/'
    flat["params/a/x"] = np.zeros(2, np.float32)
    assert leaf_order(flat) == _jax_paths(_jax_tree(flat))
    assert sorted(flat) != _jax_paths(_jax_tree(flat))


@pytest.mark.parametrize("spec", CODECS)
@pytest.mark.parametrize("zeros", [False, True])
def test_wire_arrays_byte_identical_and_decode_equal(spec, zeros):
    flat = _leaves(seed=3, zeros=zeros)
    jcodec, tcodec = jc.get_codec(spec), tc.get_codec(spec)
    assert tcodec.spec == jcodec.spec
    key_j, key_t = jc.derive_key(11, 4, 9), tc.derive_key(11, 4, 9)
    ct_j = jcodec.encode(_jax_tree(flat), key=key_j, is_delta=True)
    ct_t = tcodec.encode(_port_tree(flat), key=key_t, is_delta=True)
    assert list(ct_t.structure) == _jax_paths(_jax_tree(flat))
    _same_wire(ct_t, ct_j)
    dec_j = dict(zip(_jax_paths(_jax_tree(flat)),
                     jax.tree.leaves(jcodec.decode(ct_j))))
    dec_t = tcodec.decode(ct_t)
    for k, v in dec_j.items():
        _same_bytes(dec_t[k], v)
    qdq_t = tcodec.qdq(_port_tree(flat), key_t)
    for k, v in dec_t.items():
        _same_bytes(qdq_t[k], v)


@pytest.mark.parametrize("spec", ["int8", "int4"])
def test_stochastic_codecs_follow_the_key(spec):
    """Other keys draw other bits in both packages, the same in each."""
    flat = _leaves(seed=5)
    codes = []
    for key in [(0, 0, 0), (0, 1, 0), (2 ** 31 - 1, 10 ** 4, 10 ** 4)]:
        ct_j = jc.get_codec(spec).encode(_jax_tree(flat), key=jc.derive_key(*key))
        ct_t = tc.get_codec(spec).encode(_port_tree(flat), key=tc.derive_key(*key))
        _same_wire(ct_t, ct_j)
        codes.append(_np(ct_t.arrays[0][0]).tobytes())
    assert len(set(codes)) == 3


def test_int8_scale_is_the_jitted_rounding():
    """XLA rewrites ``amax / 127.0`` inside jit as ``amax * f32(1/127)``;
    the port's scale is that product, not a true division."""
    rng = np.random.default_rng(0)
    amax = np.abs(rng.normal(size=20000)).astype(np.float32) + 1e-3
    jitted = np.asarray(jax.jit(lambda a: a / 127.0)(jnp.asarray(amax)))
    prod = amax * (np.float32(1) / np.float32(127))
    assert np.array_equal(jitted.view(np.uint32), prod.view(np.uint32))
    div = amax / np.float32(127)
    assert not np.array_equal(jitted.view(np.uint32), div.view(np.uint32))


@pytest.mark.parametrize("spec,leaves,shape", [("int8", 120, (3, 11)),
                                               ("int4@16", 20, (16, 40))])
def test_scales_match_over_many_scales(spec, leaves, shape):
    """Leaves of random magnitude, ~120 int8 scales or 800 int4 block
    scales: every scale byte-identical to the reference's. A true division
    ``amax / 127`` (or ``/ 7``) differs from the jitted reciprocal product in
    a few percent of scales, so this many catch it."""
    rng = np.random.default_rng(9)
    flat = {f"params/l{i:03d}/kernel": (rng.normal(size=shape)
                                        * rng.uniform(1e-4, 1e2)).astype(np.float32)
            for i in range(leaves)}
    ct_j = jc.get_codec(spec).encode(_jax_tree(flat), key=jc.derive_key(4, 5, 6))
    ct_t = tc.get_codec(spec).encode(_port_tree(flat), key=tc.derive_key(4, 5, 6))
    _same_wire(ct_t, ct_j)


@pytest.mark.parametrize("spec", CODECS)
def test_fused_weighted_sum_matches_reference(spec):
    n = 4
    w = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)
    flats = [_leaves(seed=10 + i, zeros=i % 2 == 1) for i in range(n)]
    jcodec, tcodec = jc.get_codec(spec), tc.get_codec(spec)
    cts_j = [jcodec.encode(_jax_tree(f), key=jc.derive_key(0, 2, i), is_delta=True)
             for i, f in enumerate(flats)]
    cts_t = [tcodec.encode(_port_tree(f), key=tc.derive_key(0, 2, i), is_delta=True)
             for i, f in enumerate(flats)]
    got = tc.fused_weighted_sum(cts_t, w)
    want = dict(zip(_jax_paths(_jax_tree(flats[0])),
                    jax.tree.leaves(jc.fused_weighted_sum(cts_j, w))))
    # and against decoding each upload and summing, in the port itself
    decoded = [tcodec.decode(ct) for ct in cts_t]
    for k, v in want.items():
        g, v = _np(got[k]), np.asarray(v)
        assert g.dtype == v.dtype and g.shape == v.shape
        if g.dtype.kind != "f":
            assert np.array_equal(g, v)
            continue
        scale = max(float(np.abs(v).max()), 1e-30)
        assert float(np.abs(g - v).max()) <= 1e-6 * scale, k
        ref = sum(float(wi) * d[k].double() for wi, d in zip(w, decoded)).numpy()
        assert float(np.abs(g - ref).max()) <= 1e-6 * scale, k


@pytest.mark.parametrize("spec", ["int8", "topk", "int4", "nf4", "bf16"])
def test_error_feedback_residuals_agree_over_three_rounds(spec):
    ef_j = jc.ErrorFeedback(jc.get_codec(spec))
    ef_t = tc.ErrorFeedback(tc.get_codec(spec))
    for r in range(3):
        flat = _leaves(seed=40 + r, zeros=True)
        ct_j = ef_j.encode(_jax_tree(flat), key=jc.derive_key(1, r, 3))
        ct_t = ef_t.encode(_port_tree(flat), key=tc.derive_key(1, r, 3))
        res_j = dict(zip(_jax_paths(ef_j.residual), jax.tree.leaves(ef_j.residual)))
        for k, v in res_j.items():
            got, v = _np(ef_t.residual[k]), np.asarray(v)
            assert got.dtype == v.dtype and got.shape == v.shape
            np.testing.assert_allclose(got, v, rtol=0, atol=1e-6)
        # the wire stays byte-identical while the residuals agree to the ulp
        if spec in ("bf16", "nf4", "topk"):
            _same_wire(ct_t, ct_j)


def test_identity_error_feedback_keeps_no_state():
    ef = tc.ErrorFeedback(tc.get_codec("identity"))
    ef.encode(_port_tree(_leaves()))
    assert ef.residual is None


def test_refusals_match_the_reference():
    flat = _leaves(seed=1)
    for pkg, codec_mod, tree_of, key in (
            (jc, jcodecs, _jax_tree, jc.derive_key(0, 0, 0)),
            (tc, tcodecs, _port_tree, tc.derive_key(0, 0, 0))):
        int8 = pkg.get_codec("int8")
        good = int8.encode(tree_of(flat), key=key, is_delta=True)
        bad = int8.encode(tree_of(flat), key=key, is_delta=True)
        # a NaN scale on a host (wire) array
        bad.arrays[0][1] = np.asarray(np.nan, np.float32)
        with pytest.raises(ValueError, match="non-finite scale"):
            pkg.fused_weighted_sum([good, bad], [0.5, 0.5])
        with pytest.raises(ValueError, match="non-finite scale"):
            int8.decode(bad)
        # heterogeneous codecs
        other = pkg.get_codec("bf16").encode(tree_of(flat), key=key, is_delta=True)
        with pytest.raises(ValueError, match="heterogeneous"):
            pkg.fused_weighted_sum([good, other], [0.5, 0.5])
        # leaf count
        short = int8.encode(tree_of(flat), key=key, is_delta=True)
        short.arrays = short.arrays[:-1]
        with pytest.raises(ValueError, match="leaf count"):
            pkg.fused_weighted_sum([good, short], [0.5, 0.5])
        with pytest.raises(ValueError, match="empty"):
            pkg.fused_weighted_sum([], [])
        with pytest.raises(ValueError, match="codec mismatch"):
            pkg.get_codec("bf16").decode(good)
        with pytest.raises(ValueError, match="unknown compression codec"):
            pkg.get_codec("int7")
        with pytest.raises(ValueError, match="takes no parameter"):
            pkg.get_codec("int8@3")
        with pytest.raises(ValueError, match="power of two"):
            pkg.get_codec("int4@48")
        with pytest.raises(ValueError, match="topk ratio"):
            pkg.get_codec("topk@1.5")
        assert pkg.get_codec("") is None and pkg.get_codec("none") is None
        # a truncated 4-bit pack
        nf4 = pkg.get_codec("nf4@16")
        ct = nf4.encode(tree_of(flat), key=key)
        ct.arrays[0][0] = ct.arrays[0][0][:-1]
        with pytest.raises(ValueError, match="truncated"):
            nf4.decode(ct)
    assert tc.available_codecs() == jc.available_codecs()


def test_a10_codecs_raise_naming_their_item():
    """The A10 codecs are ported and none raises any more: the sketch codecs'
    bare tags (A10.5) resolve to the reference's default specs, and the
    masked codec's to the reference's default instance."""
    for tag in ("cms", "bloom"):
        sketch = tc.get_codec(tag)
        assert sketch.spec == jc.get_codec(tag).spec and sketch.name == tag
    masked = tc.get_codec("secagg_int8")
    assert masked.maskable and masked.spec == jc.get_codec("secagg_int8").spec


def test_trust_stack_arguments_raise_naming_a10():
    """The trust stack's part still to port raises naming its item (FHE
    A13); the ported ones (DP, attacks, defenses, integrity, contribution
    assessment) no longer raise, and with none of them on the fused path
    serves (contribution assessment asks for the client models in the
    engines, as the reference's do)."""
    class A:
        enable_contribution = True

    class F:
        enable_fhe = True

    class D:
        enable_dp = True
        integrity = True

    assert tc.requires_full_trees(tc.get_codec("int8"), A()) is False
    with pytest.raises(NotImplementedError, match="A13"):
        tc.requires_full_trees(tc.get_codec("int8"), F())
    assert tc.requires_full_trees(tc.get_codec("int8"), D()) is False
    assert tc.requires_full_trees(tc.get_codec("int8"), object()) is False


def test_derive_key_data_matches_reference():
    for seed, r, c in [(0, 0, 0), (2 ** 31 - 1, 10 ** 4, 10 ** 4), (5, 3, 2 ** 31 + 7)]:
        assert np.array_equal(tc.derive_key_data(seed, r, c),
                              jc.derive_key_data(seed, r, c))
    ids = np.arange(0, 10 ** 4, 37)
    got = tc.derive_key_data_batch(3, 17, ids)
    assert got.dtype == np.uint32
    assert np.array_equal(got, jc.derive_key_data_batch(3, 17, ids))


def test_tree_delta_keeps_int_leaves_absolute():
    flat = _leaves()
    new = _port_tree(flat)
    ref = {k: v + 1 if v.is_floating_point() else v * 0 for k, v in new.items()}
    d = tc.tree_delta(new, ref)
    assert torch.equal(d["step"], new["step"])
    back = tc.tree_undelta(ref, d)
    for k in new:
        torch.testing.assert_close(back[k], new[k], rtol=0, atol=1e-6)
