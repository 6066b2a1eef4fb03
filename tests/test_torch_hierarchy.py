"""The port's aggregation tree against the reference's (``tests/test_hierarchy.py``
and the tree legs of ``tests/test_integrity.py`` mirrored, on the CPU):

* ``TreeTopology``'s levels, children and parents equal the reference's;
* the batched threefry (``fold_in_batch``, ``uniform_batch``,
  ``normal_batch``, the per-leaf-keyed ``uniform_leaves``/``normal_leaves``)
  equals ``jax.vmap`` of the reference's draws — bit for bit, and within
  2e-5 for ``normal`` (``erfinv``); the scalar twin is unchanged;
* a chunk's batched int8 encode gives each client the bytes of the
  reference's ``codec.encode`` of that client's delta, bit for bit;
* ``reduce_cohort``/``finalize_root`` (mean, ``trimmed_mean@0.2``,
  ``median``) within 1e-6 of the reference's;
* associativity port against port: 2-tier == 3-tier == 4-tier bit for bit
  with the identity codec on 1/8-grid deltas; int8 3-tier within 6 steps of
  flat;
* ``TreeRunner`` beside the reference's on ``(1, 8, 64)`` and ``build(500,
  4)``, identity and int8, kill windows at tiers 1 and 2 and EF on: the
  same counters, evictions, rejoins, quorum closes, root weight and stats
  keys, the globals within 2e-6 (identity) or one int8 step a tier and
  round; robust tiers, central DP (2e-5), the per-tier screen, the root's
  below-quorum abort; the ``tree`` command.
"""
import json
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import telemetry as jtelemetry
from fedml_tpu import hierarchy as jh
from fedml_tpu.compression import codecs as jc
from fedml_tpu.hierarchy import partial_sum as jps
from fedml_tpu.hierarchy import runner as jrunner
from fedml_tpu.resilience import chaos as jchaos
from fedml_tpu_torch import cli as tcli
from fedml_tpu_torch import hierarchy as th
from fedml_tpu_torch.compression import codecs as tc
from fedml_tpu_torch.compression import threefry
from fedml_tpu_torch.hierarchy import partial_sum as tps
from fedml_tpu_torch.hierarchy import runner as trunner
from fedml_tpu_torch.hierarchy.edge import leaf_chunk
from fedml_tpu_torch.resilience import chaos as tchaos
from fedml_tpu_torch.telemetry import get_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IDENTITY_TOL = 2e-6  # a global leaf, identity codec: a few f32 ulps of the sums
NORMAL_TOL = 2e-5    # threefry.normal against the reference's (erfinv, ROADMAP §C)
REDUCE_TOL = 1e-6    # a fused cohort reduction against the reference's
DP_TOL = 2e-5        # central DP at the root: the noise is a normal draw

TOPOLOGIES = [(1, 2), (7, 2), (16, 3), (64, 3), (100, 3), (500, 4), (256, 4), (17, 5),
              (3, 3), (2, 6), (12_345, 4), (100_000, 3)]


def _tcounter(name):
    return get_registry().counter(name).value


def _jcounter(name):
    return jtelemetry.get_registry().counter(name).value


def _tier_counters(tiers):
    names = [f"tier/{d}/{k}" for d in range(tiers)
             for k in ("evicted", "rejoined", "quorum_closes", "quorum_failures",
                       "upload_bytes", "contributions", "screened", "restarts")]
    return names + ["resilience/restarts", "resilience/journal_salvaged",
                    "integrity/screened_uploads"]


def _run_both(jmake, tmake, rounds, tiers):
    """Run the reference's and the port's runner; returns (jout, tout, the
    counters each run added, each run's globals after every round)."""
    names = _tier_counters(tiers)
    jbefore = {n: _jcounter(n) for n in names}
    tbefore = {n: _tcounter(n) for n in names}
    jglobs, tglobs = [], []
    jr = jmake(lambda r, p: jglobs.append([np.asarray(x) for x in jax.tree.leaves(p)]))
    tr = tmake(lambda r, p: tglobs.append([p[k].numpy().copy()
                                           for k in sorted(p, key=lambda k: k.split("/"))]))
    jout, tout = jr.run(rounds), tr.run(rounds)
    jd = {n: _jcounter(n) - jbefore[n] for n in names}
    td = {n: _tcounter(n) - tbefore[n] for n in names}
    return jout, tout, jd, td, jglobs, tglobs


# -- topology ---------------------------------------------------------------
@pytest.mark.parametrize("n,tiers", TOPOLOGIES)
def test_topology_matches_reference(n, tiers):
    jt, tt = jh.TreeTopology.build(n, tiers), th.TreeTopology.build(n, tiers)
    assert tt.levels == jt.levels and tt.describe() == jt.describe()
    assert (tt.n_tiers, tt.n_clients, tt.leaf_tier) == (jt.n_tiers, jt.n_clients,
                                                        jt.leaf_tier)
    for d in range(tt.leaf_tier):
        nodes = range(tt.levels[d]) if tt.levels[d] <= 400 else (
            0, 1, tt.levels[d] // 2, tt.levels[d] - 1)
        for node in nodes:
            kids = tt.children(d, node)
            np.testing.assert_array_equal(kids, jt.children(d, node))
            for c in kids[[0, -1]] if len(kids) else ():
                assert tt.parent(d + 1, int(c)) == jt.parent(d + 1, int(c))


def test_topology_refusals_match_reference():
    for bad in ((2, 4), (1, 8, 4), (1,)):
        with pytest.raises(ValueError):
            jh.TreeTopology(bad)
        with pytest.raises(ValueError):
            th.TreeTopology(bad)
    with pytest.raises(ValueError):
        th.TreeTopology.build(0)
    with pytest.raises(ValueError, match="no children"):
        th.TreeTopology((1, 4)).children(1, 0)
    with pytest.raises(ValueError, match="no parent"):
        th.TreeTopology((1, 4)).parent(0, 0)


# -- the batched threefry ---------------------------------------------------
def _keys(n, seed=0):
    kd = np.random.default_rng(seed).integers(0, 2 ** 32, size=(n, 2), dtype=np.uint32)
    return kd, torch.from_numpy(kd.astype(np.int64)), jax.vmap(jax.random.wrap_key_data)(
        jnp.asarray(kd))


@pytest.mark.parametrize("draw", ["fold_in", "fold_in_rows", "fold_in_many", "uniform",
                                  "normal", "uniform_leaves", "normal_leaves"])
def test_batched_threefry_matches_vmap(draw):
    _, tk, jk = _keys(6)
    if draw == "fold_in":
        got = threefry.fold_in_batch(tk, 0x40000007).numpy().astype(np.uint32)
        want = np.asarray(jax.vmap(lambda k: jax.random.key_data(
            jax.random.fold_in(k, 0x40000007)))(jk))
    elif draw == "fold_in_rows":
        data = np.arange(6, dtype=np.uint32) * 977
        got = threefry.fold_in_batch(tk, torch.from_numpy(data.astype(np.int64))).numpy()
        want = np.asarray(jax.vmap(lambda k, d: jax.random.key_data(
            jax.random.fold_in(k, d)))(jk, jnp.asarray(data)))
        got = got.astype(np.uint32)
    elif draw == "fold_in_many":
        got = threefry.fold_in_many(tk, (1, 2, 0xFFFFFFFF)).numpy().astype(np.uint32)
        want = np.stack([np.asarray(jax.vmap(lambda k, d=d: jax.random.key_data(
            jax.random.fold_in(k, d)))(jk)) for d in (1, 2, 0xFFFFFFFF)], axis=1)
    elif draw == "uniform":
        got = threefry.uniform_batch(tk, (5, 7)).numpy()
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (5, 7)))(jk))
    elif draw == "normal":
        got = threefry.normal_batch(tk, (300,)).numpy()
        want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (300,)))(jk))
        assert np.abs(got - want).max() <= NORMAL_TOL
        return
    else:
        ids, shapes = [0, 2, 3], [(4, 3), (5,), ()]
        sizes = [int(np.prod(s)) for s in shapes]
        fn = threefry.uniform_leaves if draw == "uniform_leaves" else threefry.normal_leaves
        jfn = jax.random.uniform if draw == "uniform_leaves" else jax.random.normal
        got = fn(tk, ids, sizes).numpy()
        want = np.concatenate([np.asarray(jax.vmap(
            lambda k, i=i, s=s: jfn(jax.random.fold_in(k, i), s))(jk)).reshape(6, -1)
            for i, s in zip(ids, shapes)], axis=1)
        if draw == "normal_leaves":
            assert np.abs(got - want).max() <= NORMAL_TOL
            return
    np.testing.assert_array_equal(got, want)


def test_scalar_threefry_is_unchanged():
    k = threefry.fold_in(threefry.key(11), 3)
    jk = jax.random.fold_in(jax.random.key(11), 3)
    np.testing.assert_array_equal(threefry.key_data(k), np.asarray(jax.random.key_data(jk)))
    np.testing.assert_array_equal(threefry.uniform(k, (9,)).numpy(),
                                  np.asarray(jax.random.uniform(jk, (9,))))
    # a batched row is the scalar draw of that row's key
    keys = torch.stack([k, threefry.fold_in(k, 1)])
    np.testing.assert_array_equal(threefry.uniform_batch(keys, (9,))[1].numpy(),
                                  threefry.uniform(threefry.fold_in(k, 1), (9,)).numpy())


# -- the batched encode -----------------------------------------------------
def _uniform_delta_fns(shapes):
    """Deltas ``uniform - 0.5`` per leaf under ``fold_in(key, leaf)``: exact
    in f32, so the reference's jitted program and the port draw the same."""

    def jfn(key):
        return tuple(jax.random.uniform(jax.random.fold_in(key, i), sh) - 0.5
                     for i, sh in enumerate(shapes))

    ids, sizes = list(range(len(shapes))), [int(np.prod(sh)) for sh in shapes]

    def tfn(keys):
        flat = threefry.uniform_leaves(keys, ids, sizes) - 0.5
        out, off = [], 0
        for sh, n in zip(shapes, sizes):
            out.append(flat[:, off:off + n].reshape((keys.shape[0],) + tuple(sh)))
            off += n
        return tuple(out)

    return jfn, tfn


def test_batched_int8_encode_equals_reference_encode_per_client():
    shapes = [(3,), (6, 5), (2, 2, 3)]  # the reference's leaf order of the tree below
    jfn, tfn = _uniform_delta_fns(shapes)
    kd, tk, _ = _keys(5, seed=3)
    codec = tc.get_codec("int8")
    leaves = tfn(threefry.fold_in_batch(tk, 1))
    meta = tuple(("float32", sh) for sh in shapes)
    enc = codec.encode_batch(leaves, meta, threefry.fold_in_batch(tk, 2))
    jcodec = jc.get_codec("int8")
    for c in range(5):
        key = jax.random.wrap_key_data(jnp.asarray(kd[c]))
        jl = jfn(jax.random.fold_in(key, 1))
        for x, y in zip(jl, leaves):
            np.testing.assert_array_equal(np.asarray(x), y[c].numpy())
        tree = {"a": {"bias": jl[0], "kernel": jl[1]}, "b": jl[2]}
        ct = jcodec.encode(tree, key=jax.random.fold_in(key, 2), is_delta=True)
        assert len(ct.arrays) == 3
        for i, parts in enumerate(ct.arrays):
            np.testing.assert_array_equal(enc[i][0][c].numpy(), np.asarray(parts[0]))
            np.testing.assert_array_equal(enc[i][1][c].numpy(), np.asarray(parts[1]))


def test_leaf_chunk_sum_equals_reference_program():
    """One chunk through ``leaf_chunk`` and through the reference's jitted
    program: the same unnormalized sum within 1e-6 (einsum order), and EF
    residuals the same."""
    shapes = [(4,), (8, 3)]
    meta = tuple(("float32", sh) for sh in shapes)
    jfn, tfn = _uniform_delta_fns(shapes)
    kd, tk, _ = _keys(8, seed=5)
    w = np.asarray([1, 2, 0, 1, 1, 3, 0, 1], np.float32)
    res_np = [np.random.default_rng(1).normal(size=(8,) + sh).astype(np.float32) * 0.01
              for sh in shapes]
    from fedml_tpu.hierarchy.edge import _leaf_chunk_program

    for codec in ("int8", "identity"):
        jsum, jres = _leaf_chunk_program(jc.get_codec(codec), meta, jfn, True, "mean", 0.0,
                                         jnp.asarray(kd), jnp.asarray(w),
                                         tuple(jnp.asarray(r) for r in res_np))
        tsum, tres = leaf_chunk(tc.get_codec(codec), meta, tfn, True, "mean", 0.0, tk,
                                torch.from_numpy(w), tuple(torch.from_numpy(r) for r in res_np))
        for a, b in zip(jsum, tsum):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= REDUCE_TOL
        for a, b in zip(jres, tres):
            assert np.abs(np.asarray(a) - b.numpy()).max() <= REDUCE_TOL


# -- partial sums -----------------------------------------------------------
def _cts(n=5, shape=(6, 4)):
    rng = np.random.default_rng(2)
    deltas = [{"w": rng.normal(size=shape).astype(np.float32),
               "b": rng.normal(size=shape[-1:]).astype(np.float32)} for _ in range(n)]
    jcts = [jc.get_codec("int8").encode(d, key=jc.derive_key(0, 0, i), is_delta=True)
            for i, d in enumerate(deltas)]
    tcts = [tc.get_codec("int8").encode({k: torch.from_numpy(v) for k, v in d.items()},
                                        key=tc.derive_key(0, 0, i), is_delta=True)
            for i, d in enumerate(deltas)]
    return jcts, tcts


@pytest.mark.parametrize("agg_robust", [None, "trimmed_mean@0.2", "median"])
def test_reduce_cohort_and_finalize_root_match_reference(agg_robust):
    jcts, tcts = _cts()
    weights = [3.0, 1.0, 2.0, 5.0, 1.0]
    for a, b in zip(jcts, tcts):  # the same contributions on both sides
        for pa, pb in zip(a.arrays, b.arrays):
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(np.asarray(x), y.numpy())
    jp = jps.reduce_cohort(list(zip(jcts, weights)), jc.get_codec("identity"),
                           jc.derive_key(0, 1, 7), counts=[1, 2, 1, 1, 3],
                           agg_robust=agg_robust)
    tp = tps.reduce_cohort(list(zip(tcts, weights)), tc.get_codec("identity"),
                           tc.derive_key(0, 1, 7), counts=[1, 2, 1, 1, 3],
                           agg_robust=agg_robust)
    assert (tp.weight, tp.count) == (jp.weight, jp.count) == (12.0, 8)
    assert tp.nbytes == jps.compressed_nbytes(jp.ct)
    for pa, pb in zip(jp.ct.arrays, tp.ct.arrays):
        assert np.abs(np.asarray(pa[0]) - pb[0].numpy()).max() <= REDUCE_TOL
    jm, jw = jps.finalize_root(list(zip(jcts, weights)), agg_robust=agg_robust)
    tm, tw = tps.finalize_root(list(zip(tcts, weights)), agg_robust=agg_robust)
    assert tw == jw == 12.0
    for k in ("w", "b"):
        assert np.abs(np.asarray(jm[k]) - tm[k].numpy()).max() <= REDUCE_TOL
    if agg_robust is None:
        flat = tps.flat_reference(list(zip(tcts, weights)))
        assert all(torch.equal(flat[k], tm[k]) for k in flat)
    with pytest.raises(ValueError, match="empty cohort"):
        tps.reduce_cohort([], tc.get_codec("int8"), tc.derive_key(0, 0, 0))


# -- associativity, port against port ---------------------------------------
def _exact_delta_fn(meta):
    """Exactly representable deltas (multiples of 1/8), as the reference's
    test draws them: any summation order is exact."""
    ids, sizes = list(range(len(meta))), [int(np.prod(sh)) for _, sh in meta]

    def fn(keys):
        flat = torch.round(8 * threefry.normal_leaves(keys, ids, sizes)) / 8
        out, off = [], 0
        for (_, sh), n in zip(meta, sizes):
            out.append(flat[:, off:off + n].reshape((keys.shape[0],) + tuple(sh)))
            off += n
        return tuple(out)

    return fn


def _run_tree(levels, codec, rounds=2, **kw):
    tmpl = {"w": np.zeros((16, 8), np.float32), "b": np.zeros((8,), np.float32)}
    meta = (("float32", (8,)), ("float32", (16, 8)))
    r = th.TreeRunner(th.TreeTopology(levels), template=tmpl, codec=codec, seed=0,
                      delta_fn=kw.pop("delta_fn", _exact_delta_fn(meta)), device="cpu", **kw)
    return r.run(rounds), [x.numpy() for x in r.global_leaves]


def test_partial_sums_associative_identity_bit_identical():
    d2, g2 = _run_tree((1, 64), "identity")
    d3, g3 = _run_tree((1, 8, 64), "identity")
    d4, g4 = _run_tree((1, 4, 16, 64), "identity")
    assert d2["final_digest"] == d3["final_digest"] == d4["final_digest"]
    for a, b, c in zip(g2, g3, g4):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_int8_tree_within_quantization_tolerance_of_flat():
    _, g2 = _run_tree((1, 64), "int8")
    _, g3 = _run_tree((1, 8, 64), "int8")
    for a, b in zip(g2, g3):
        step = max(np.abs(a).max(), np.abs(b).max()) / 127.0
        assert np.abs(a - b).max() <= 6 * step + 1e-7, (np.abs(a - b).max(), step)


# -- the runner against the reference's ------------------------------------
def _globals_close(jglobs, tglobs, codec, tiers):
    """Round by round: identity within IDENTITY_TOL; int8 within one
    quantization step a tier for every round so far (a step is the round's
    largest move of the leaf over 127)."""
    budget = [0.0] * len(jglobs[0])
    prev = [np.zeros_like(x) for x in jglobs[0]]
    for r, (jg, tg) in enumerate(zip(jglobs, tglobs)):
        for i, (a, b) in enumerate(zip(jg, tg)):
            err = float(np.abs(a - b).max())
            if codec == "identity":
                assert err <= IDENTITY_TOL, (r, i, err)
                continue
            budget[i] += (tiers - 1) * float(np.abs(a - prev[i]).max()) / 127.0
            assert err <= budget[i] + 1e-7, (r, i, err, budget[i])
        prev = jg


@pytest.mark.parametrize("codec", ["identity", "int8"])
@pytest.mark.parametrize("shape", ["(1, 8, 64)", "build(500, 4)"])
def test_tree_runner_matches_reference(shape, codec):
    levels = (1, 8, 64) if shape == "(1, 8, 64)" else jh.TreeTopology.build(500, 4).levels
    chaos = [(1, 2, 1, None), (2, 5, 0, 2)] if len(levels) == 3 else [
        (1, 3, 1, None), (2, 11, 0, 2), (3, 40, 1, None)]
    kw = dict(codec=codec, seed=4, quorum=0.5, chunk=16, ef=True)

    def jmake(on_round):
        return jh.TreeRunner(jh.TreeTopology(levels), template=jrunner.default_template(96),
                             chaos=[jh.KillWindow(*c) for c in chaos], on_round=on_round, **kw)

    def tmake(on_round):
        return th.TreeRunner(th.TreeTopology(levels), template=trunner.default_template(96),
                             chaos=[th.KillWindow(*c) for c in chaos], on_round=on_round,
                             device="cpu", **kw)

    jout, tout, jd, td, jglobs, tglobs = _run_both(jmake, tmake, 3, len(levels))
    assert td == jd
    assert sum(td[f"tier/{d}/evicted"] for d in range(len(levels))) >= 2
    assert sum(td[f"tier/{d}/rejoined"] for d in range(len(levels))) >= 1
    assert sorted(tout) == sorted(jout)
    for k in ("clients", "tiers", "levels", "rounds", "codec", "agg_robust", "secagg",
              "dp_sigma", "root_total_weight", "seed", "quorum", "per_client_wire_bytes",
              "f32_tree_nbytes", "per_tier", "completed"):
        assert tout[k] == jout[k], k
    _globals_close(jglobs, tglobs, codec, len(levels))


@pytest.mark.parametrize("agg_robust", ["trimmed_mean@0.2", "median"])
def test_robust_tree_matches_reference(agg_robust):
    kw = dict(codec="int8", seed=3, quorum=0.5, agg_robust=agg_robust)

    def jmake(on_round):
        return jh.TreeRunner(jh.TreeTopology((1, 4, 48)), on_round=on_round, **kw)

    def tmake(on_round):
        return th.TreeRunner(th.TreeTopology((1, 4, 48)), on_round=on_round, device="cpu",
                             **kw)

    jout, tout, jd, td, jglobs, tglobs = _run_both(jmake, tmake, 2, 3)
    assert td == jd and tout["agg_robust"] == jout["agg_robust"] == agg_robust
    assert tout["per_tier"] == jout["per_tier"]
    _globals_close(jglobs, tglobs, "int8", 3)


def test_tree_robust_bit_identical_and_no_f32_trees():
    """The reference's acceptance leg: trimmed-mean tiers end bit-identical
    across two same-seed runs and no tier buffers near a per-client f32 set."""
    outs = [th.TreeRunner(th.TreeTopology((1, 8, 512)), codec="int8", seed=3, quorum=0.5,
                          agg_robust="trimmed_mean@0.2", device="cpu").run(2)
            for _ in range(2)]
    assert outs[0]["final_digest"] == outs[1]["final_digest"]
    f32_all = outs[0]["f32_tree_nbytes"] * outs[0]["clients"]
    for d, row in outs[0]["per_tier"].items():
        assert row["peak_buffer_bytes"] < 0.05 * f32_all, (d, row)


def test_tree_median_matches_flat_median_identity():
    runner = th.TreeRunner(th.TreeTopology((1, 9)), codec="identity", seed=4, quorum=1.0,
                           agg_robust="median", device="cpu")
    assert runner.run(1)["completed"]
    from fedml_tpu_torch.integrity.robust_agg import robust_reduce_leaf

    keys = torch.from_numpy(tc.derive_key_data_batch(4, 0, np.arange(9)).astype(np.int64))
    deltas = runner.delta_fn(threefry.fold_in_batch(keys, 1))
    for got, stack in zip(runner.global_leaves, deltas):
        want = robust_reduce_leaf(stack, "median", 0)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


def test_root_below_quorum_aborts_loudly():
    chaos = [th.KillWindow(1, e, 0) for e in range(3)]  # 3 of 4 edges dead
    r = th.TreeRunner(th.TreeTopology((1, 4, 16)), codec="int8", seed=0, quorum=0.75,
                      chaos=chaos, device="cpu")
    with pytest.raises(RuntimeError, match="below quorum at the root"):
        r.run(1)
    two = th.TreeRunner(th.TreeTopology((1, 4)), codec="int8", quorum=1.0,
                        chaos=[th.KillWindow(1, 0, 0)], device="cpu")
    with pytest.raises(RuntimeError, match="below quorum at the root"):
        two.run(1)


def test_central_dp_at_the_root_matches_reference():
    kw = dict(codec="identity", seed=2, quorum=1.0, dp_sigma=0.5)
    jr = jh.TreeRunner(jh.TreeTopology((1, 4, 32)), **kw)
    tr = th.TreeRunner(th.TreeTopology((1, 4, 32)), device="cpu", **kw)
    jout, tout = jr.run(2), tr.run(2)
    assert tout["dp_sigma"] == jout["dp_sigma"] == 0.5
    for a, b in zip(jr.global_leaves, tr.global_leaves):
        assert np.abs(np.asarray(a) - b.numpy()).max() <= DP_TOL
    assert trunner.last_dp_trace() == {"pre_noise_traced": True, "noised_in_program": True}
    assert jrunner.last_dp_trace() == trunner.last_dp_trace()
    plain = th.TreeRunner(th.TreeTopology((1, 4, 32)), codec="identity", seed=2,
                          device="cpu")
    plain.run(2)
    moved = max(float((a - b).abs().max()) for a, b in zip(plain.global_leaves,
                                                           tr.global_leaves))
    assert moved > 1e-3  # the noise landed


def test_corrupt_uplink_screened_per_tier_matches_reference():
    kw = dict(codec="int8", seed=5, quorum=0.5, screen=True)

    def jmake(on_round):
        return jh.TreeRunner(jh.TreeTopology((1, 4, 96)), on_round=on_round,
                             chaos=[jchaos.CorruptUpdateWindow(2, 1, mode="scale",
                                                               factor=100.0, tier=1)], **kw)

    def tmake(on_round):
        return th.TreeRunner(th.TreeTopology((1, 4, 96)), on_round=on_round, device="cpu",
                             chaos=[tchaos.CorruptUpdateWindow(2, 1, mode="scale",
                                                               factor=100.0, tier=1)], **kw)

    jout, tout, jd, td, jglobs, tglobs = _run_both(jmake, tmake, 3, 3)
    assert td == jd and td["tier/1/screened"] >= 1
    assert td["integrity/screened_uploads"] >= 1
    for g in tglobs[-1]:
        assert np.isfinite(g).all()
    _globals_close(jglobs, tglobs, "int8", 3)


def test_edge_aggregator_quorum_close_and_deadline():
    codec = tc.get_codec("int8")
    agg = th.EdgeAggregator(1, 0, [10, 11, 12], codec, quorum_frac=2 / 3, device="cpu")
    assert agg.begin_round(0) == [10, 11, 12]
    fired = threading.Event()
    agg.arm_deadline(0.05, lambda r: fired.set())
    assert fired.wait(2.0), "RoundDeadline never fired"

    def ps(cid):
        ct = codec.encode({"w": torch.ones(4, 4)}, key=tc.derive_key(0, 0, cid),
                          is_delta=True)
        return th.PartialSum(ct, weight=2.0, count=1)

    assert agg.offer(10, ps(10)) and agg.offer(11, ps(11))
    assert not agg.offer(99, ps(99)) and not agg.offer(10, ps(10))
    assert agg.quorum_met() and not agg.all_received()
    partial, missing = agg.close_round(tc.derive_key(0, 0, 0))
    assert missing == [12] and agg.evicted() == [12]
    assert partial is not None and partial.weight == 4.0 and partial.nbytes == 16 + 4
    assert agg.begin_round(1) == [10, 11]
    assert agg.readmit(12) and agg.begin_round(1) == [10, 11, 12]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            th.EdgeAggregator(1, 0, [1], codec)


def test_rejoining_client_ef_residual_reset_at_edge():
    r = th.TreeRunner(th.TreeTopology((1, 2, 16)), codec="int8", seed=0, quorum=0.5,
                      ef=True, chaos=[th.KillWindow(2, 5, 1, 99)], device="cpu")
    r.run(3)
    cohort = r.cohorts[0]
    assert bool(cohort.evicted_mask[5])
    assert any(bool((x != 0).any()) for x in cohort.residual_rows(5))
    back = cohort.readmit(np.asarray([5]))
    assert list(back) == [5]
    assert all(bool((x == 0).all()) for x in cohort.residual_rows(5))
    assert any(bool((x != 0).any()) for x in cohort.residual_rows(4))


def test_killed_edge_rejoins_and_runs_are_deterministic():
    def run():
        before = {n: _tcounter(n) for n in ("tier/1/evicted", "tier/1/rejoined",
                                            "tier/0/quorum_closes")}
        out = th.TreeRunner(th.TreeTopology((1, 8, 64)), codec="int8", seed=7, quorum=0.5,
                            chaos=[th.KillWindow(1, 2, 1)], device="cpu").run(4)
        return out, {n: _tcounter(n) - v for n, v in before.items()}

    (a, ca), (b, cb) = run(), run()
    assert ca == cb == {"tier/1/evicted": 1, "tier/1/rejoined": 1,
                        "tier/0/quorum_closes": 1}
    assert a["final_digest"] == b["final_digest"]


def test_unported_tree_options_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="A12"):
        th.TreeRunner(th.TreeTopology((1, 4)), live=object(), device="cpu")
    with pytest.raises(ValueError, match="needs a codec"):
        th.TreeRunner(th.TreeTopology((1, 4)), codec="none", device="cpu")
    with pytest.raises(ValueError, match="float-leaf"):
        th.TreeRunner(th.TreeTopology((1, 4)), template={"n": np.zeros(3, np.int32)},
                      device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            th.TreeRunner(th.TreeTopology((1, 4)))


# -- the tree command -------------------------------------------------------
def test_tree_command_prints_one_json_line():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "fedml_tpu_torch.cli", "tree", "--clients", "300",
         "--tiers", "3", "--rounds", "2", "--params", "128", "--quorum", "0.5",
         "--kill-tier", "1", "--kill-node", "3", "--kill-round", "1", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["completed"] and out["clients"] == 300 and out["codec"] == "int8"
    ref = jh.TreeRunner(jh.TreeTopology.build(300, 3), template=jrunner.default_template(128),
                        codec="int8", seed=0, quorum=0.5,
                        chaos=[jh.KillWindow(1, 3, 1)]).run(2)
    for k in ("levels", "root_total_weight", "per_client_wire_bytes", "f32_tree_nbytes",
              "per_tier"):
        assert out[k] == ref[k], k


def test_tree_command_below_quorum_and_refusals(capsys):
    rc = tcli.main(["tree", "--clients", "20", "--tiers", "3", "--rounds", "1",
                    "--quorum", "1.0", "--kill-tier", "1", "--kill-node", "0",
                    "--kill-round", "0", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert rc == 1 and len(out) == 1
    res = json.loads(out[0])
    assert res["completed"] is False and "below quorum at the root" in res["error"]
    for flag in (["--metrics-port", "0"], ["--trace-rounds", "1"]):
        with pytest.raises(NotImplementedError, match="A12"):
            tcli.main(["tree", "--clients", "20", "--device", "cpu", *flag])
