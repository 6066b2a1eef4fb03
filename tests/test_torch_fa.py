"""The port's federated analytics against the reference's (``tests/test_fa.py``
and ``tests/test_fa_sketch.py`` mirrored, on the CPU):

* hashing and randomness, exact: the tensor ``hash_bucket`` against numpy's
  and ``jax_hash_bucket`` at the uint32 edges, ``hash_family`` and
  ``item_to_u32``, ``threefry.randint_batch`` against ``jax.random.randint``
  under ``vmap``, the word stream against the reference's ``gen_ids``;
* the sketch codecs, exact: wire bytes of seeded integer and dyadic tables,
  ``_dyadic_scale`` at its edges, the fused merge rescaled to the integer
  sum, ``get_codec``'s specs, the hostile-wire corpus rejected case by case
  with the reference's exception;
* the sketches themselves (the port's own copy) against the reference's
  tables, and the reference's algebra tests;
* the FSM: every task through ``run_fa_inproc`` (plaintext and sketch) equal
  to the reference's result on the same data, spec negotiation, the config
  path, quorum close, the stale submission, the abort below quorum and the
  spoofed wire, with the reference's counters;
* the federation: flat, 2-tier and 3-tier sum tables and digests equal to
  the reference's (the digest hashes the same leaf bytes), SecAgg masked ==
  plain == the reference's, central DP (sum tables within 1e-4: the erfinv
  difference of ``threefry.normal``, ~2e-5 a draw, times σ), the epsilon
  accounting, the 256-client chaos acceptance with the same counters;
* the ``fa`` command's JSON lines equal the reference's for seed 0.
"""
import copy
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import telemetry as jtelemetry
from fedml_tpu.arguments import load_arguments_from_dict as jload
from fedml_tpu.compression import codecs as jc
from fedml_tpu.compression.codecs import derive_key_data_batch as j_kd_batch
from fedml_tpu.fa import run_fa_inproc as j_run_fa
from fedml_tpu.fa.sketch import codec as jcodec
from fedml_tpu.fa.sketch import federation as jfed
from fedml_tpu.fa.sketch import sketches as jsk
from fedml_tpu.hierarchy import runner as jrunner
from fedml_tpu.hierarchy.tree import TreeTopology
from fedml_tpu_torch.arguments import load_arguments_from_dict as tload
from fedml_tpu_torch.compression import codecs as tc
from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.fa import run_fa_inproc as t_run_fa
from fedml_tpu_torch.fa.sketch import codec as tcodec
from fedml_tpu_torch.fa.sketch import federation as tfed
from fedml_tpu_torch.fa.sketch import sketches as tsk
from fedml_tpu_torch.hierarchy import runner as trunner
from fedml_tpu_torch.telemetry import get_registry

DP_SUM_TOL = 1e-4  # a noised sum-table cell: ~2e-5 a normal draw (erfinv), times σ
AVG_TOL = 0.0      # the avg task sums Python floats in the same order: exact

_FED = dict(codec="votevec@512/3", seed=3, vocab=64, n_hot=6, p_hot=0.6,
            words_per_client=16, hh_threshold_frac=0.03)


def _jtotal(name):
    return sum(m.get("value", 0) for m in jtelemetry.get_registry().snapshot()
               if m["name"] == name)


def _ttotal(name):
    return get_registry().total(name)


class _Deltas:
    """Counter deltas of a block on both sides: ``.j[name]``, ``.t[name]``."""

    def __init__(self, names):
        self.names = list(names)

    def __enter__(self):
        self._j = {n: _jtotal(n) for n in self.names}
        self._t = {n: _ttotal(n) for n in self.names}
        return self

    def __exit__(self, *exc):
        self.j = {n: _jtotal(n) - self._j[n] for n in self.names}
        self.t = {n: _ttotal(n) - self._t[n] for n in self.names}
        return False


FA_COUNTERS = ("fa/rounds", "fa/quorum_rounds", "fa/deadline_fired", "fa/aborts",
               "fa/stale_submissions", "fa/screened")


def ns(**kw):
    a = types.SimpleNamespace(random_seed=7, rank=0)
    for k, v in kw.items():
        setattr(a, k, v)
    return a


def _same_result(j, t):
    """Results of the two FSMs: equal keys, sets/counts/specs exact, numpy
    arrays as lists."""
    def norm(v):
        if isinstance(v, (np.ndarray, jnp.ndarray)):
            return np.asarray(v).tolist()
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        return v

    assert norm(j) == norm(t)


# -- hashing and randomness ---------------------------------------------------
_EDGES = np.asarray([0, 1, 2, (1 << 31) - 1, 1 << 31, (1 << 31) + 1, (1 << 32) - 2,
                     (1 << 32) - 1], np.uint64)


@pytest.mark.parametrize("width", [2, 7, 1024, 4096, 12_345])
@pytest.mark.parametrize("salt", ["cms", "votevec", "bloom"])
def test_hash_bucket_matches_numpy_and_jax(width, salt):
    """The tensor hash lands in numpy's and ``jax_hash_bucket``'s cells,
    exactly, at the uint32 edges and on random ids."""
    a_rows, b_rows, _, _ = tsk.hash_family(13, 4, salt)
    x = np.concatenate([_EDGES, np.random.default_rng(width).integers(
        0, 1 << 32, 2048, dtype=np.uint64)])
    xt = torch.from_numpy(x.astype(np.int64))
    for r in range(4):
        host = jsk.hash_bucket(x, int(a_rows[r]), int(b_rows[r]), width)
        dev = np.asarray(jfed.jax_hash_bucket(jnp.asarray(x.astype(np.uint32)),
                                              int(a_rows[r]), int(b_rows[r]), width))
        got = tfed.hash_bucket(xt, int(a_rows[r]), int(b_rows[r]), width).numpy()
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got, dev)
    # the edges of the constants themselves
    for a, b in ((0, 0), (1, 0), ((1 << 32) - 1, (1 << 32) - 1), (1 << 31, 1 << 31)):
        np.testing.assert_array_equal(tfed.hash_bucket(xt, a, b, width).numpy(),
                                      jsk.hash_bucket(x, a, b, width))


@pytest.mark.parametrize("salt", ["cms", "csk", "votevec", "bloom"])
@pytest.mark.parametrize("seed", [0, 7, (1 << 32) + 3])
def test_hash_family_and_item_ids_match(salt, seed):
    for got, want in zip(tsk.hash_family(seed, 5, salt), jsk.hash_family(seed, 5, salt)):
        np.testing.assert_array_equal(got, want)
    for item in (5, (1 << 32) + 5, -1, True, np.int64(9), "apple", "apples", 3.5, ("a", 1)):
        assert tsk.item_to_u32(item) == jsk.item_to_u32(item)


@pytest.mark.parametrize("lo,hi", [(0, 6), (0, 12), (0, 64), (0, 512), (0, 1000), (3, 17),
                                   (-5, 100), (0, 70_000), (0, (1 << 31) - 1), (5, 5),
                                   (7, 3)])
def test_randint_batch_matches_jax_bit_for_bit(lo, hi):
    kd = np.random.default_rng(hi).integers(0, 1 << 32, (33, 2), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        jax.random.wrap_key_data(k), (3, 37), lo, hi))(jnp.asarray(kd)))
    got = threefry.randint_batch(torch.from_numpy(kd.astype(np.int64)), (3, 37), lo, hi)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("vocab,n_hot,p_hot,words", [(64, 6, 0.6, 16), (512, 12, 0.5, 32),
                                                     (1000, 7, 0.3, 5)])
def test_word_stream_matches_reference(vocab, n_hot, p_hot, words):
    """``make_word_stream`` on a ``derive_key_data_batch`` batch gives the
    reference's ``gen_ids`` under ``vmap``, id for id."""
    kd = j_kd_batch(3, 0, np.arange(200))
    np.testing.assert_array_equal(kd, tc.derive_key_data_batch(3, 0, np.arange(200)))
    jgen = jfed.make_word_stream(vocab, n_hot, p_hot, words)
    want = np.asarray(jax.vmap(lambda k: jgen(jax.random.wrap_key_data(k)))(jnp.asarray(kd)))
    got = tfed.make_word_stream(vocab, n_hot, p_hot, words)(torch.from_numpy(kd.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_vote_delta_fn_matches_reference():
    """The chunk's batched vote tables equal the reference's per-client
    scatter-add, exactly, and the probe records a device tensor."""
    gen_j = jfed.make_word_stream(64, 6, 0.6, 16)
    gen_t = tfed.make_word_stream(64, 6, 0.6, 16)
    jfn = jfed.make_vote_delta_fn(128, 3, 5, "votevec", gen_j)
    tfn = tfed.make_vote_delta_fn(128, 3, 5, "votevec", gen_t)
    kd = j_kd_batch(5, 0, np.arange(24))
    want = np.stack([np.asarray(jfn(jax.random.wrap_key_data(jnp.asarray(k)))[0]) for k in kd])
    (got,) = tfn(torch.from_numpy(kd.astype(np.int64)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (24, 3, 128)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tfed.last_sketch_trace()["client_sketch_traced"] is True


def test_reference_counts_match():
    gen_j = jfed.make_word_stream(64, 6, 0.6, 16)
    gen_t = tfed.make_word_stream(64, 6, 0.6, 16)
    ids = [0, 3, 5, 17, 100, 511]
    np.testing.assert_array_equal(
        tfed.reference_sketch_counts(3, 0, ids, gen_t, 64, chunk=4, device="cpu"),
        jfed.reference_sketch_counts(3, 0, ids, gen_j, 64, chunk=4))


# -- the sketch codecs ----------------------------------------------------------
_SPECS = ["cms@64/3", "csk@64/3", "votevec@128/3", "bloom@512/2", "hist@32/0/10"]


def _table(spec, rng, dyadic=False):
    c = tc.get_codec(spec)
    shape = c._expected_shape()
    lo = -300 if not c.nonneg else 0
    x = rng.integers(lo, 3000, shape).astype(np.float32)
    if dyadic:
        x = x / np.float32(8.0)
    return x


@pytest.mark.parametrize("spec", _SPECS)
@pytest.mark.parametrize("dyadic", [False, True])
def test_sketch_encode_bytes_match(spec, dyadic):
    """``[q, scale]`` bytes of a seeded integer (or 1/8-grid) table equal the
    reference's, and decode is exact."""
    x = _table(spec, np.random.default_rng(len(spec)), dyadic)
    jct = jc.get_codec(spec).encode({"table": jnp.asarray(x)}, key=None, is_delta=False)
    tct = tc.get_codec(spec).encode({"table": torch.from_numpy(x)}, key=None, is_delta=False)
    assert tct.codec == jct.codec and tct.meta == jct.meta
    for jp, tp in zip(jct.arrays[0], tct.arrays[0]):
        assert np.asarray(jp).tobytes() == tp.numpy().tobytes()
        assert str(np.asarray(jp).dtype) == str(tp.dtype).replace("torch.", "")
    np.testing.assert_array_equal(tc.get_codec(spec).decode(tct)["table"].numpy(), x)


@pytest.mark.parametrize("v", [0.0, 0.3, 1.0, 2.0, 3.0, 4.0, 1024.0, 1025.0, 65_535.0,
                               65_536.0, 65_537.0, float((1 << 23) - 1), float(1 << 23),
                               1e30])
def test_dyadic_scale_edges(v):
    want = np.asarray(jcodec._dyadic_scale(jnp.float32(v)))
    got = tcodec._dyadic_scale(torch.tensor(v, dtype=torch.float32))
    assert got.numpy().tobytes() == want.tobytes()
    # batched: one scale a row
    rows = tcodec._dyadic_scale(torch.tensor([v, 1.0, v + 1.0], dtype=torch.float32))
    assert rows[0].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("spec", ["cms@64/3", "votevec@128/3", "bloom@512/2"])
def test_encode_batch_rows_equal_encode_leaf(spec):
    """The tree's batched leaf encode gives row ``c`` the bytes of the
    one-client encode (one dyadic scale a row and leaf)."""
    rng = np.random.default_rng(1)
    codec = tc.get_codec(spec)
    x = np.stack([_table(spec, rng) for _ in range(5)])
    x[2] = 0.0  # an empty table's scale
    q, scale = codec.encode_leaf_batch(torch.from_numpy(x), None)
    for c in range(5):
        jq, js = jc.get_codec(spec).encode_leaf(jnp.asarray(x[c]), None)
        assert q[c].numpy().tobytes() == np.asarray(jq).tobytes()
        assert scale[c].numpy().tobytes() == np.asarray(js).tobytes()


@pytest.mark.parametrize("n", [2, 3, 5, 6, 8])
def test_fused_merge_matches_host_sum_and_reference(n):
    """The fused weighted mean at w = 1/n, rescaled by ``rint(· n)``, lands on
    the integer sum for cohorts that are not powers of two as well."""
    rng = np.random.default_rng(n)
    tables, jcts, tcts = [], [], []
    for _ in range(n):
        sk = tsk.VoteVectorSketch(128, 3, seed=4)
        sk.add(rng.integers(0, 500, 200))
        tables.append(sk.table.copy())
        leaf = sk.leaves()["table"]
        jcts.append(jc.get_codec("votevec@128/3").encode({"table": jnp.asarray(leaf)}))
        tcts.append(tc.get_codec("votevec@128/3").encode({"table": torch.from_numpy(leaf)}))
    w = np.full(n, 1.0 / n, np.float32)
    tmean = tc.fused_weighted_sum(tcts, w)["table"].double().numpy()
    jmean = np.asarray(jc.fused_weighted_sum(jcts, w)["table"], np.float64)
    np.testing.assert_array_equal(np.rint(tmean * n), np.sum(tables, axis=0))
    np.testing.assert_array_equal(np.rint(tmean * n), np.rint(jmean * n))


@pytest.mark.parametrize("spec,args", [
    ("bloom@512/2", None), ("hist@32/0/10", None), ("cms@128/2", None), ("csk", None),
    ("votevec", None), ("cms", {"fa_sketch_width": 256, "fa_sketch_depth": 5}),
    ("votevec", {"fa_vote_width": 4096}), ("bloom", {"fa_bloom_bits": 1024}),
    ("hist", {"fa_hist_bins": 16, "fa_hist_lo": -1.0, "fa_hist_hi": 1.0})])
def test_get_codec_specs_match(spec, args):
    a = types.SimpleNamespace(**args) if args else None
    t, j = tc.get_codec(spec, a), jc.get_codec(spec, a)
    assert t.spec == j.spec and t.name == j.name
    assert tc.get_codec(t.spec) is tc.get_codec(t.spec)  # the instance cache
    for name in ("cms", "csk", "votevec", "bloom", "hist"):
        assert name in tc.available_codecs()


@pytest.mark.parametrize("task", ["frequency_estimation", "heavy_hitter_triehh", "union",
                                  "intersection", "cardinality", "histogram",
                                  "k_percentile_element", "avg"])
def test_sketch_spec_for_task_matches(task):
    a = types.SimpleNamespace(fa_vote_width=512)
    assert tcodec.sketch_spec_for_task(task, a) == jcodec.sketch_spec_for_task(task, a)
    assert tcodec.sketch_spec_for_task(task) == jcodec.sketch_spec_for_task(task)


def _rewire(mod, ct, arrays):
    return mod.CompressedTree(ct.codec, ct.version, ct.is_delta, ct.raw_nbytes, ct.meta,
                              ct.structure, arrays, ct.sa)


_HOSTILE = {
    "truncated parts": ("truncated", lambda q, s: [[q]], None),
    "missing leaf": ("truncated", lambda q, s: [], None),
    "foreign geometry": ("foreign-geometry", None, "cms@32/3"),
    "non-dyadic scale": ("power of two", lambda q, s: [[q, np.asarray(3.7, np.float32)]], None),
    "negative counters": ("negative", lambda q, s: [[-np.abs(q // 2) - 1, s]], None),
    "past 2^23": ("2\\^23", lambda q, s: [[np.full_like(q, 1 << 24), s]], None),
    "counter dtype": ("dtype", lambda q, s: [[q.astype(np.float32), s]], None),
    "non-finite scale": ("non-finite", lambda q, s: [[q, np.asarray(np.nan, np.float32)]], None),
}


@pytest.mark.parametrize("case", sorted(_HOSTILE))
@pytest.mark.parametrize("as_tensor", [False, True])
def test_hostile_wire_rejected_like_reference(case, as_tensor):
    """The reference's hostile-wire corpus: each payload is refused by both
    gates with ``ValueError`` (numpy blocks, or CPU tensors on the port)."""
    match, forge, other_spec = _HOSTILE[case]
    sk = tsk.CountMinSketch(64, 3, seed=1)
    sk.add([1, 2, 3, 4])
    leaf = sk.leaves()["table"]
    jct = jc.get_codec("cms@64/3").encode({"table": jnp.asarray(leaf)}, key=None)
    tct = tc.get_codec("cms@64/3").encode({"table": torch.from_numpy(leaf)}, key=None)
    q, s = np.asarray(jct.arrays[0][0]), np.asarray(jct.arrays[0][1])
    jc.get_codec("cms@64/3").check_wire(jct)
    tc.get_codec("cms@64/3").check_wire(tct)
    if forge is None:
        jbad, tbad = jct, tct
    else:
        arrays = forge(q, s)
        jbad = _rewire(jc, jct, arrays)
        tarrays = [[torch.from_numpy(np.array(p)) for p in parts]
                   for parts in arrays] if as_tensor else arrays
        tbad = _rewire(tc, tct, tarrays)
    spec = other_spec or "cms@64/3"
    with pytest.raises(ValueError, match=match):
        jc.get_codec(spec).check_wire(jbad)
    with pytest.raises(ValueError, match=match):
        tc.get_codec(spec).check_wire(tbad)


def test_sketch_codec_roundtrip_exact():
    codec = tc.get_codec("cms@64/3")
    sk = tsk.CountMinSketch(64, 3, seed=1)
    sk.add(np.random.default_rng(0).integers(0, 1000, 5000))
    ct = codec.encode({"table": torch.from_numpy(sk.leaves()["table"])})
    np.testing.assert_array_equal(codec.decode(ct)["table"].numpy(), sk.leaves()["table"])
    m, _ = np.frexp(float(ct.arrays[0][1]))
    assert m == 0.5


# -- the sketches: the port's copy beside the reference's --------------------
@pytest.mark.parametrize("cls", ["CountMinSketch", "CountSketch", "VoteVectorSketch"])
def test_table_sketches_match_reference(cls):
    rng = np.random.default_rng(2)
    items = list(rng.integers(0, 400, 3000)) + ["apple", "pear", "apple"]
    t, j = getattr(tsk, cls)(256, 3, seed=5), getattr(jsk, cls)(256, 3, seed=5)
    t.add(items)
    j.add(items)
    np.testing.assert_array_equal(t.table, j.table)
    for it in (0, 7, "apple", "kiwi"):
        assert t.query(it) == j.query(it)


def test_bloom_histogram_and_votes_match_reference():
    tb, jb = tsk.BloomSketch(2048, 3, seed=5), jsk.BloomSketch(2048, 3, seed=5)
    for s in (tb, jb):
        s.add([f"u{i}" for i in range(60)])
    np.testing.assert_array_equal(tb.vector, jb.vector)
    assert tb.estimate_cardinality() == jb.estimate_cardinality()
    th, jh = tsk.HistogramSketch(0.0, 100.0, 64), jsk.HistogramSketch(0.0, 100.0, 64)
    for h in (th, jh):
        h.add(np.arange(-5, 105, 0.5))
    np.testing.assert_array_equal(th.counts, jh.counts)
    assert th.quantile(50) == jh.quantile(50)
    tv, jv = tsk.VoteVectorSketch(128, 3, seed=2), jsk.VoteVectorSketch(128, 3, seed=2)
    for v in (tv, jv):
        v.vote(["sun", "moon", "sea"], ["s", "m"], 2)
    np.testing.assert_array_equal(tv.table, jv.table)


def test_cms_overestimate_bound():
    rng = np.random.default_rng(1)
    items = np.minimum(rng.zipf(1.3, 20_000) - 1, 4999).astype(np.int64)
    sk = tsk.CountMinSketch(512, 4, seed=3)
    sk.add(items)
    true = np.bincount(items, minlength=5000)
    queries = list(range(50)) + rng.integers(0, 5000, 100).tolist()
    violations = 0
    for it in queries:
        est = sk.query(int(it))
        assert est >= true[it]
        violations += est - true[it] > sk.epsilon * len(items)
    assert violations / len(queries) <= 0.05


def test_sketch_merge_equals_bulk():
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 400, 5000), rng.integers(0, 400, 3000)
    for cls in (tsk.CountMinSketch, tsk.CountSketch, tsk.VoteVectorSketch):
        s1, s2, bulk = (cls(256, 3, seed=5) for _ in range(3))
        s1.add(a)
        s2.add(b)
        s1.merge(s2)
        bulk.add(np.concatenate([a, b]))
        np.testing.assert_array_equal(s1.table, bulk.table)
    b1, b2 = tsk.BloomSketch(2048, 3, seed=5), tsk.BloomSketch(2048, 3, seed=5)
    b1.add(a)
    b2.add(b)
    b1.merge(b2)
    for it in np.unique(np.concatenate([a, b]))[:100]:
        assert b1.contains(int(it))


def test_bloom_cardinality_and_intersection():
    b1, b2 = tsk.BloomSketch(4096, 4, seed=9), tsk.BloomSketch(4096, 4, seed=9)
    b1.add([f"u{i}" for i in range(60)])
    b2.add([f"u{i}" for i in range(40, 100)])
    b1.merge(b2)
    assert abs(b1.estimate_cardinality(threshold=1) - 100) <= 10
    for i in range(45, 55):
        assert b1.contains(f"u{i}", threshold=2)
    assert not b1.contains("u5", threshold=2)


def test_histogram_k_percentile():
    h = tsk.HistogramSketch(0.0, 100.0, 64)
    h.add(np.arange(0, 100, 0.5))
    assert 45 <= h.quantile(50) <= 55
    assert 85 <= tsk.k_percentile_from_histogram(h.counts, h.edges, 90) <= 95


def test_merge_geometry_mismatch_refused():
    s1 = tsk.CountMinSketch(256, 3, seed=5)
    with pytest.raises(ValueError):
        s1.merge(tsk.CountMinSketch(128, 3, seed=5))
    with pytest.raises(ValueError):
        s1.merge(tsk.CountMinSketch(256, 3, seed=6))


# -- the FSM ------------------------------------------------------------------
def _numeric():
    rng = np.random.default_rng(0)
    return {r: rng.normal(loc=r, scale=2.0, size=50 + 10 * r) for r in (1, 2, 3)}


_WORDS = ["spam"] * 6 + ["ham"] * 5 + ["eggs"] * 2 + ["rare"]
np.random.default_rng(1).shuffle(_WORDS)

_PLAIN_CASES = {
    "avg": (_numeric, {}),
    "frequency_estimation": (lambda: {1: list("aabbc"), 2: list("bbccd"), 3: list("ccdda")}, {}),
    "union": (lambda: {1: ["x", "y", "z"], 2: ["y", "z", "w"], 3: ["z", "q"]}, {}),
    "intersection": (lambda: {1: ["x", "y", "z"], 2: ["y", "z", "w"], 3: ["z", "q"]}, {}),
    "cardinality": (lambda: {1: ["x", "y", "z"], 2: ["y", "z", "w"], 3: ["z", "q"]}, {}),
    "histogram": (_numeric, {"fa_hist_bins": 8}),
    "k_percentile_element": (_numeric, {"fa_k_percentile": 75, "fa_percentile_tol": 1e-6}),
    "heavy_hitter_triehh": (lambda: {1: _WORDS[:5], 2: _WORDS[5:10], 3: _WORDS[10:]},
                            {"fa_theta": 4}),
}


def _cfg(task, run_id, **extra):
    return {"common_args": {"training_type": "federated_analytics", "random_seed": 0,
                            "run_id": run_id},
            "fa_args": {"fa_task": task, **extra}}


@pytest.mark.parametrize("task", sorted(_PLAIN_CASES))
def test_plaintext_tasks_match_reference(task):
    """Every task of ``tests/test_fa.py`` through the port's FSM equals the
    reference's result on the same data, with the same ``fa/rounds``."""
    make, extra = _PLAIN_CASES[task]
    with _Deltas(FA_COUNTERS) as d:
        j = j_run_fa(fedml_tpu.init(jload(_cfg(task, f"jfa_{task}", **extra))), make())
        t = t_run_fa(fedml_tpu_torch.init(tload(_cfg(task, f"tfa_{task}", **extra))), make(),
                     device="cpu")
    _same_result(j, t)
    assert d.j == d.t
    if task == "avg":
        assert abs(t["avg"] - j["avg"]) <= AVG_TOL
    if task == "heavy_hitter_triehh":
        assert set(t["heavy_hitters"]) == {"spam", "ham"}


_SKETCH_CASES = {
    "frequency_estimation": (dict(fa_sketch="auto", fa_query_items=["a", "b", "c"]),
                             {1: ["a"] * 5 + ["b"] * 2, 2: ["a"] * 3 + ["c"], 3: ["b"] * 4}),
    "frequency_estimation@csk": (dict(fa_sketch="csk@256/5", fa_query_items=["a", "b", "z"]),
                                 {1: ["a"] * 5 + ["b"] * 2, 2: ["a"] * 3 + ["c"], 3: ["b"] * 4}),
    "heavy_hitter_triehh": (dict(fa_sketch="auto", fa_theta=3, fa_max_word_len=8),
                            {1: ["sun", "sun", "moon"], 2: ["sun", "star", "moon"],
                             3: ["sun", "moon", "moon"]}),
    "k_percentile_element": (dict(fa_sketch="hist@64/0/100", fa_k_percentile=50),
                             {1: list(range(0, 40)), 2: list(range(40, 80)),
                              3: list(range(80, 100))}),
    "histogram": (dict(fa_sketch="hist@16/0/100"),
                  {1: list(range(0, 40)), 2: list(range(40, 80)), 3: list(range(80, 100)),
                   4: [5, 5, 5], 5: [150.0, -3.0]}),
    "union": (dict(fa_sketch="bloom@1024/3", fa_query_items=["u1", "u45", "zz"]),
              {1: [f"u{i}" for i in range(40)], 2: [f"u{i}" for i in range(20, 60)]}),
    "intersection": (dict(fa_sketch="auto", fa_query_items=["u1", "u45", "u25"]),
                     {1: [f"u{i}" for i in range(40)], 2: [f"u{i}" for i in range(20, 60)],
                      3: [f"u{i}" for i in range(25, 30)]}),
    "cardinality": (dict(fa_sketch="auto"),
                    {1: [f"u{i}" for i in range(40)], 2: [f"u{i}" for i in range(20, 60)]}),
    "avg": (dict(fa_sketch="auto"), {1: [1.0, 2.0], 2: [3.5], 3: [4.0, 5.0, 6.0]}),
}


@pytest.mark.parametrize("case", sorted(_SKETCH_CASES))
def test_sketch_tasks_match_reference(case):
    """Sketch mode (``tests/test_fa_sketch.py``'s FSM cases and the other
    families) through the port's FSM equals the reference's result: the
    merged integer tables, estimates, specs and rounds."""
    task = case.split("@")[0]
    kw, data = _SKETCH_CASES[case]
    with _Deltas(FA_COUNTERS) as d:
        j = j_run_fa(ns(run_id=f"jfs_{case}", fa_task=task, **kw), data)
        t = t_run_fa(ns(run_id=f"tfs_{case}", fa_task=task, **kw), data, device="cpu")
    _same_result(j, t)
    assert d.j == d.t
    if case == "frequency_estimation":
        assert t["total"] == 15 and t["estimates"] == {"a": 8, "b": 6, "c": 1}
    if case == "heavy_hitter_triehh":
        assert set(t["heavy_hitters"]) == {"sun", "moon"} and t["rounds"] > 1
    if case == "k_percentile_element":
        assert t["rounds"] == 1 and 45 <= t["value"] <= 55


def test_fsm_spec_negotiation_header_wins():
    res = t_run_fa(ns(run_id="tfas_nego", fa_task="frequency_estimation",
                      fa_sketch="cms@128/2", fa_query_items=["x"]),
                   {1: ["x", "y"], 2: ["x"]}, device="cpu")
    assert res["spec"] == res["sketch_spec"] == "cms@128/2"
    assert res["estimates"]["x"] == 2


def test_fsm_config_path_integration():
    cfg = {"common_args": {"training_type": "federated_analytics", "random_seed": 0,
                           "run_id": "tfas_cfg"},
           "fa_args": {"fa_task": "cardinality", "fa_sketch": "auto"}}
    data = {1: [f"u{i}" for i in range(40)], 2: [f"u{i}" for i in range(20, 60)]}
    t = t_run_fa(fedml_tpu_torch.init(tload(cfg)), data, device="cpu")
    cfg["common_args"]["run_id"] = "jfas_cfg"
    j = j_run_fa(fedml_tpu.init(jload(cfg)), data)
    assert 50 <= t["cardinality"] <= 70 and t["spec"].startswith("bloom@")
    _same_result(j, t)


def test_fa_unknown_task_raises():
    with pytest.raises(ValueError):
        t_run_fa(tload(_cfg("nope", "tfa_x")), {1: [1.0]}, device="cpu")


def _managers(side, task, n, silent=(), run_id="fas_q", stale=(), spoof=None, **kw):
    """The reference's ``_build_managers`` for either package."""
    if side == "jax":
        from fedml_tpu.core.distributed.communication.local_comm import LocalBroker
        from fedml_tpu.core.distributed.message import Message
        from fedml_tpu.fa.aggregator import create_aggregator
        from fedml_tpu.fa.analyzer import create_analyzer
        from fedml_tpu.fa.fa_client_manager import FAClientManager
        from fedml_tpu.fa.fa_message_define import FAMessage
        from fedml_tpu.fa.fa_server_manager import FAServerManager
        dev = {}
    else:
        from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
        from fedml_tpu_torch.core.distributed.message import Message
        from fedml_tpu_torch.fa.aggregator import create_aggregator
        from fedml_tpu_torch.fa.analyzer import create_analyzer
        from fedml_tpu_torch.fa.fa_client_manager import FAClientManager
        from fedml_tpu_torch.fa.fa_message_define import FAMessage
        from fedml_tpu_torch.fa.fa_server_manager import FAServerManager
        dev = {"device": "cpu"}

    class SilentClient(FAClientManager):
        def handle_analyze_request(self, msg):
            pass

    class StaleClient(FAClientManager):
        def handle_analyze_request(self, msg):
            M = FAMessage
            round_idx = int(msg.get(M.MSG_ARG_KEY_ROUND, 0))
            m = Message(M.MSG_TYPE_C2S_SUBMIT, self.get_sender_id(), 0)
            m.add_params(M.MSG_ARG_KEY_SUBMISSION, {"bogus": 1})
            m.add_params(M.MSG_ARG_KEY_ROUND, round_idx - 1)
            self.send_message(m)
            super().handle_analyze_request(msg)

    run_id = f"{side}_{run_id}"
    LocalBroker.destroy(run_id)
    args = ns(run_id=run_id, fa_task=task, **kw)
    mgrs = [FAServerManager(args, create_aggregator(task, args, **dev), client_rank=0,
                            client_num=n)]
    for rank in range(1, n + 1):
        cargs = copy.copy(args)
        cargs.rank = rank
        cls = SilentClient if rank in silent else StaleClient if rank in stale \
            else FAClientManager
        an = create_analyzer(task, cargs, **dev)
        if spoof is not None and rank == spoof[0]:
            # refuse negotiation and encode under a foreign geometry
            an.set_sketch_spec = lambda spec: None
            an.spec = spoof[1]
        mgrs.append(cls(cargs, an, ["apple"] * rank, rank=rank, size=n + 1))
    return mgrs, run_id


def _run_side(side, mgrs, run_id, timeout=30.0):
    if side == "jax":
        from fedml_tpu.cross_silo.run_inproc import run_managers_to_completion
    else:
        from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion
    return run_managers_to_completion(mgrs, run_id, "MSG_TYPE_CONNECTION_IS_READY", timeout)


_RESILIENCE = {
    "quorum close": (dict(silent={3}, fa_sketch="auto", fa_query_items=["apple"],
                          round_deadline_s=0.8, round_quorum=0.66), 3, None),
    "stale submission": (dict(stale={2}, fa_sketch="", fa_query_items=[]), 2, None),
    "abort below quorum": (dict(silent={1, 2}, fa_sketch="auto", round_deadline_s=0.3,
                                round_quorum=1.0, deadline_extensions=1), 2, "below quorum"),
    "spoofed wire": (dict(fa_sketch="cms@64/2", fa_query_items=[], spoof=(2, "cms@32/2")),
                     2, "client 2"),
}


@pytest.mark.parametrize("case", sorted(_RESILIENCE))
def test_fsm_resilience_matches_reference(case):
    """Quorum close, a stale submission, the abort below quorum and a spoofed
    wire behave as the reference's: the same result or the same failure, and
    the same ``fa/*`` counters."""
    kw, n, raises = _RESILIENCE[case]
    out, counts = {}, {}
    for side in ("jax", "torch"):
        with _Deltas(FA_COUNTERS) as d:
            mgrs, rid = _managers(side, "frequency_estimation", n,
                                  run_id=case.replace(" ", "_"), **kw)
            if raises:
                with pytest.raises(RuntimeError, match=raises):
                    _run_side(side, mgrs, rid)
            else:
                out[side] = _run_side(side, mgrs, rid)
        counts[side] = d.j if side == "jax" else d.t
    if case == "quorum close":
        # the deadline's fires are timer-paced: a quorum close each side
        assert counts["torch"]["fa/quorum_rounds"] == counts["jax"]["fa/quorum_rounds"] == 1
        assert counts["torch"]["fa/deadline_fired"] >= 1 and counts["jax"]["fa/deadline_fired"] >= 1
        assert out["torch"]["estimates"]["apple"] == out["jax"]["estimates"]["apple"] == 3
    else:
        assert counts["torch"] == counts["jax"]
    if case == "stale submission":
        assert out["torch"] == out["jax"] and out["torch"]["frequencies"] == {"apple": 1.0}
        assert counts["torch"]["fa/stale_submissions"] >= 1
    if case == "abort below quorum":
        assert counts["torch"]["fa/aborts"] == 1


def test_fsm_screen_admits_honest_sketches():
    """``fa_screen`` runs integrity ring 1 on the sketch wires; honest
    submissions pass it and the result is the unscreened one."""
    data = {1: ["a"] * 5 + ["b"] * 2, 2: ["a"] * 3 + ["c"], 3: ["b"] * 4}
    kw = dict(fa_task="frequency_estimation", fa_sketch="auto", fa_query_items=["a", "b"])
    with _Deltas(FA_COUNTERS) as d:
        t = t_run_fa(ns(run_id="tfas_screen", fa_screen=True, **kw), data, device="cpu")
        j = j_run_fa(ns(run_id="jfas_screen", fa_screen=True, **kw), data)
    assert t["estimates"] == j["estimates"] == {"a": 8, "b": 6}
    assert d.t["fa/screened"] == d.j["fa/screened"] == 0


# -- the federation -------------------------------------------------------------
class _Captured:
    """Patch a federation module's TreeRunner to keep the runners it built."""

    def __init__(self, monkeypatch, mod, base):
        self.runners = []
        outer = self

        class Recording(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                outer.runners.append(self)

        monkeypatch.setattr(mod, "TreeRunner", Recording)

    def sum_table(self, rint=True):
        r = self.runners[-1]
        g = r.global_leaves[0]
        g = g.cpu().double().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float64)
        s = g * float(r.last_root_weight)
        return np.rint(s).astype(np.int64) if rint else s


def _both(monkeypatch, **kw):
    jcap = _Captured(monkeypatch, jfed, jrunner.TreeRunner)
    tcap = _Captured(monkeypatch, tfed, trunner.TreeRunner)
    j = jfed.run_sketch_federation(**kw)
    t = tfed.run_sketch_federation(device="cpu", **kw)
    return j, t, jcap, tcap


_SAME_KEYS = ("spec", "clients", "levels", "secagg", "dp_sigma", "dp_epsilon", "threshold",
              "heavy_hitters", "ref_heavy_hitters", "hh_recall", "hh_precision",
              "root_total_weight", "per_client_wire_bytes", "plain_sketch_bytes",
              "wire_overhead")


@pytest.mark.parametrize("levels", [(1, 64), (1, 8, 64), (1, 4, 16, 64)],
                         ids=["flat", "2-tier", "3-tier"])
def test_federation_sum_tables_match_reference(monkeypatch, levels):
    """Flat, 2-tier and 3-tier on 64 clients: the sum table equals the
    reference's exactly, and so do the heavy hitters and the digest (both
    hash the global leaf's f32 bytes)."""
    j, t, jcap, tcap = _both(monkeypatch, n_clients=64, levels=levels, **_FED)
    np.testing.assert_array_equal(tcap.sum_table(), jcap.sum_table())
    for k in _SAME_KEYS:
        assert t[k] == j[k], k
    assert t["final_digest"] == j["final_digest"]
    assert t["hh_recall"] == 1.0 and t["hh_precision"] == 1.0
    assert t["per_client_wire_bytes"] == 4 * 3 * 512 + 4


def test_merge_identity_flat_2tier_3tier():
    """Power-of-two fan-outs: every cohort mean is dyadic, so the port's
    federated sum is bit-identical however the tree re-associates it."""
    outs = [tfed.run_sketch_federation(n_clients=64, levels=lv, device="cpu", **_FED)
            for lv in ((1, 64), (1, 8, 64), (1, 4, 16, 64))]
    assert len({o["final_digest"] for o in outs}) == 1
    assert all(o["heavy_hitters"] == outs[0]["ref_heavy_hitters"] for o in outs)


def test_secagg_masked_equals_plain_and_reference(monkeypatch):
    plain = tfed.run_sketch_federation(n_clients=64, levels=(1, 8, 64), device="cpu", **_FED)
    j, t, jcap, tcap = _both(monkeypatch, n_clients=64, levels=(1, 8, 64), secagg=True, **_FED)
    assert t["final_digest"] == plain["final_digest"] == j["final_digest"]
    assert t["heavy_hitters"] == plain["heavy_hitters"] == j["heavy_hitters"]
    np.testing.assert_array_equal(tcap.sum_table(), jcap.sum_table())
    assert tfed.last_sketch_trace()["client_sketch_traced"] is True


def test_central_dp_matches_reference_within_tolerance(monkeypatch):
    kw = dict(n_clients=64, levels=(1, 8, 64), secagg=True, dp_sigma=1.5, **_FED)
    j, t, jcap, tcap = _both(monkeypatch, **kw)
    tr = trunner.last_dp_trace()
    assert tr["pre_noise_traced"] is True and tr["noised_in_program"] is True
    assert 0 < t["dp_epsilon"] == j["dp_epsilon"] < float("inf")
    assert t["heavy_hitters"] == j["heavy_hitters"]
    np.testing.assert_allclose(tcap.sum_table(rint=False), jcap.sum_table(rint=False),
                               rtol=0, atol=DP_SUM_TOL)
    again = tfed.run_sketch_federation(device="cpu", **kw)
    assert again["final_digest"] == t["final_digest"]
    plain = tfed.run_sketch_federation(n_clients=64, levels=(1, 8, 64), secagg=True,
                                       device="cpu", **_FED)
    assert plain["final_digest"] != t["final_digest"]


@pytest.mark.parametrize("sigma,sens,rounds,delta", [(0.0, 1.0, 1, 1e-6), (10.0, 1.0, 1, 1e-6),
                                                     (10.0, 1.0, 4, 1e-6), (20.0, 1.0, 1, 1e-6),
                                                     (2.0, 55.4, 1, 1e-5)])
def test_zcdp_epsilon_matches(sigma, sens, rounds, delta):
    assert tfed.zcdp_epsilon(sigma, sens, rounds, delta) == jfed.zcdp_epsilon(
        sigma, sens, rounds, delta)


def _chaos_acceptance(side, n_clients, levels, tmp_path, run_tag):
    """The reference's chaos-acceptance scenario for either package: leaf
    kills, an edge kill and a root crash with a journal restart, under
    SecAgg with central DP."""
    mod = jrunner if side == "jax" else trunner
    topo = TreeTopology(levels)
    leaf_tier = topo.leaf_tier
    dead_leaves = [3, n_clients // 2, n_clients - 5]
    cohort = topo.children(leaf_tier - 1, 1)
    survivors = sorted(set(range(n_clients)) - set(dead_leaves) - set(int(c) for c in cohort))
    chaos = [mod.KillWindow(leaf_tier, c, 0) for c in dead_leaves]
    chaos.append(mod.KillWindow(leaf_tier - 1, 1, 0))
    chaos.append(mod.EdgeKillWindow(0, 0, 0, after_children=2))
    return dict(n_clients=n_clients, levels=levels, quorum=0.5, secagg=True, dp_sigma=2.0,
                chaos=chaos, durability_dir=str(tmp_path / f"{side}_{run_tag}"),
                reference_client_ids=survivors, **_FED), survivors


_ACCEPT_COUNTERS = ("resilience/restarts", "resilience/journal_salvaged",
                    "resilience/journal_replays", "tier/2/evicted", "tier/1/evicted",
                    "tier/0/quorum_closes", "tier/1/quorum_closes", "secagg/hier_recoveries",
                    "secagg/hier_cohort_rounds", "fa/rounds")


def test_acceptance_chaos_small(tmp_path):
    """The reference's 256-client chaos acceptance on the port beside the
    reference's run: the same survivors, heavy hitters (the plaintext
    reference's), weight and counters; two port runs digest-equal."""
    jkw, survivors = _chaos_acceptance("jax", 256, (1, 8, 256), tmp_path, "a")
    tkw, _ = _chaos_acceptance("torch", 256, (1, 8, 256), tmp_path, "a")
    with _Deltas(_ACCEPT_COUNTERS) as d:
        j = jfed.run_sketch_federation(**jkw)
        t = tfed.run_sketch_federation(device="cpu", **tkw)
    assert t["stats"]["completed"]
    assert t["root_total_weight"] == j["root_total_weight"] == float(len(survivors))
    assert t["heavy_hitters"] == t["ref_heavy_hitters"] == j["heavy_hitters"]
    assert t["hh_recall"] == 1.0 and t["hh_precision"] == 1.0
    assert d.t == d.j
    assert d.t["resilience/restarts"] >= 1 and d.t["resilience/journal_salvaged"] >= 1
    assert tfed.last_sketch_trace()["client_sketch_traced"] is True
    assert trunner.last_dp_trace()["noised_in_program"] is True
    tkw2, _ = _chaos_acceptance("torch", 256, (1, 8, 256), tmp_path, "b")
    assert tfed.run_sketch_federation(device="cpu", **tkw2)["final_digest"] == t["final_digest"]


def test_federation_refuses_signed_codec():
    with pytest.raises(ValueError, match="unsigned table codec"):
        tfed.run_sketch_federation(n_clients=8, levels=(1, 8), codec="csk@64/3", device="cpu")


# -- the command ----------------------------------------------------------------
_CLI_CASES = [["--task", t] for t in ("avg", "heavy_hitter_triehh", "union", "intersection",
                                      "cardinality", "frequency_estimation",
                                      "k_percentile_element", "histogram")] + [
    ["--task", "frequency_estimation", "--deadline-s", "2", "--quorum", "0.5"],
    ["--task", "frequency_estimation", "--sketch", "", "--query", "sun,moon"],
    ["--task", "heavy_hitter_triehh", "--theta", "6", "--clients", "4"],
    ["--federation", "--fed-clients", "256", "--dp-sigma", "0"],
]


@pytest.mark.parametrize("argv", _CLI_CASES, ids=lambda a: " ".join(a))
def test_fa_command_matches_reference(argv, capsys):
    """``fa`` prints the reference command's JSON line for seed 0 (the
    federation leg's DP-free line, with SecAgg on)."""
    from click.testing import CliRunner

    from fedml_tpu.cli import cli as jcli
    from fedml_tpu_torch import cli as tcli

    res = CliRunner().invoke(jcli, ["fa", *argv, "--seed", "0"])
    assert res.exit_code == 0, res.output
    want = json.loads(res.output.strip().splitlines()[-1])
    assert tcli.main(["fa", *argv, "--seed", "0", "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    if "--federation" in argv:
        for k in ("rounds_per_s",):  # wall clocks
            want.pop(k), got.pop(k)
    assert got == want
    if argv == ["--task", "heavy_hitter_triehh"]:
        assert {"sun", "moon"} <= set(got["heavy_hitters"])
