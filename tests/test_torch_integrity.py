"""The port's integrity rings (``fedml_tpu_torch/integrity``) against the
reference's (``fedml_tpu/integrity``) on the CPU, on the same inputs made
from a seed with numpy:

* ``screen_stats`` of every codec's wire tree (the wire arrays are the
  reference's bit for bit), with planted NaN and Inf blocks: the same
  finite flag, and the total and per-leaf norms within 1e-6 relative;
* ``UpdateScreen`` over a scripted sequence of uploads: the same drops, the
  same reasons and the same ``integrity/*`` counts; ``QuarantineList`` and
  ``AcceptanceGuard`` over scripted calls: the same answers;
* ``fused_robust_sum`` for the median and ``trimmed_mean@{0.1,0.2,0.45}``
  over cohorts of 3, 4, 5 and 10 (even ones included): within 1e-6 of the
  reference's, relative to the aggregate's magnitude; and on identity
  deltas plus a base it equals the trimmed-mean and median defenses of the
  full models within float rounding (1e-6);
* every refusal of ``fused_robust_sum`` and ``agg_compressed``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu import compression as jc
from fedml_tpu import integrity as ji
from fedml_tpu.ml.aggregator.agg_operator import FedMLAggOperator as JAgg
from fedml_tpu.resilience.chaos import corrupt_model_payload
from fedml_tpu.telemetry import get_registry as jregistry
from fedml_tpu_torch import compression as tc
from fedml_tpu_torch import integrity as ti
from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
from fedml_tpu_torch.core.security.attacker import FedMLAttacker
from fedml_tpu_torch.core.security.defender import FedMLDefender
from fedml_tpu_torch.integrity.robust_agg import masked_robust_leaf, trim_k
from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator as TAgg
from fedml_tpu_torch.resilience import chaos as tchaos
from fedml_tpu_torch.telemetry import get_registry as tregistry

LEAVES = (("w", (8, 6)), ("b", (6,)), ("k", (3, 3, 2, 4)))
INTEGRITY = ("integrity/screened_uploads", "integrity/nonfinite_uploads",
             "integrity/norm_overflows", "integrity/z_outliers", "integrity/quarantined",
             "integrity/quarantine_released", "integrity/rollbacks",
             "integrity/rollback_aborts")


@pytest.fixture(autouse=True)
def _reset_port_singletons():
    yield
    FedMLAttacker.reset()
    FedMLDefender.reset()
    FedMLDifferentialPrivacy.reset()


def _deltas(n, seed=0, scale=1e-2):
    out = []
    for c in range(n):
        rng = np.random.default_rng(seed + c)
        out.append({k: (rng.normal(size=sh) * scale).astype(np.float32)
                    for k, sh in LEAVES})
    return out


def _jt(flat):
    return {k: jnp.asarray(v) for k, v in flat.items()}


def _tt(flat):
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flat.items()}


def _encode_pair(codec, flat, cid, seed=0):
    key_j, key_t = jc.derive_key(seed, 1, cid), tc.derive_key(seed, 1, cid)
    return (jc.get_codec(codec).encode(_jt(flat), key=key_j, is_delta=True),
            tc.get_codec(codec).encode(_tt(flat), key=key_t, is_delta=True))


# the reference's ``corrupt_model_payload`` on a port wire tree: the port's
# own, in ``resilience.chaos``
port_corrupt = tchaos.corrupt_model_payload


def _plant(ct, jax_side, leaf, value):
    """``value`` into a float leaf's last floating part (the scale of int8
    and 4-bit leaves, the kept values of top-k, the values of identity and
    bf16): the first element of the first leaf, or the last of the last."""
    arrays = [[np.array(p, copy=True) if jax_side else p.clone() for p in parts]
              for parts in ct.arrays]
    parts = arrays[leaf]
    k = max(i for i, p in enumerate(parts)
            if (jnp.issubdtype(p.dtype, jnp.floating) if jax_side else p.is_floating_point()))
    flat = parts[k].reshape(-1)
    flat[0 if leaf == 0 else -1] = value
    cls = jc.CompressedTree if jax_side else tc.CompressedTree
    return cls(ct.codec, ct.version, ct.is_delta, ct.raw_nbytes, ct.meta, ct.structure,
               arrays)


def _same_stats(got, want):
    assert got.finite == want.finite
    if not want.finite or not math.isfinite(want.norm):
        assert not math.isfinite(got.norm) or not got.finite
        return
    assert got.norm == pytest.approx(want.norm, rel=1e-6)
    np.testing.assert_allclose(got.leaf_norms, want.leaf_norms, rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("codec", ["identity", "bf16", "int8", "topk", "int4", "nf4"])
@pytest.mark.parametrize("plant", [None, "nan", "inf"])
def test_screen_stats_match_reference(codec, plant):
    flat = _deltas(1)[0]
    jct, tct = _encode_pair(codec, flat, 3)
    if plant == "nan":
        jct, tct = _plant(jct, True, 0, np.nan), _plant(tct, False, 0, float("nan"))
    elif plant == "inf":
        jct, tct = _plant(jct, True, -1, np.inf), _plant(tct, False, -1, float("inf"))
    got, want = ti.screen_stats(tct), ji.screen_stats(jct)
    _same_stats(got, want)
    assert got.finite is (plant is None)


def test_screen_stats_of_plain_trees_against_a_base():
    a, b = _deltas(2, seed=5, scale=1.0)
    _same_stats(ti.screen_stats(_tt(a), base=_tt(b)), ji.screen_stats(_jt(a), base=_jt(b)))
    _same_stats(ti.screen_stats(_tt(a)), ji.screen_stats(_jt(a)))
    a["w"][2, 3] = np.nan
    _same_stats(ti.screen_stats(_tt(a), base=_tt(b)), ji.screen_stats(_jt(a), base=_jt(b)))


def _counts(reg):
    return {n: reg.counter(n).value for n in INTEGRITY}


def test_update_screen_scripted_uploads_match_reference():
    """Three rounds of five clients: honest uploads build the norm history;
    round 1 has an upload whose scale arrives NaN and a 40× block in one
    leaf (a z outlier whose total norm stays inside the envelope); round 2 a
    30× upload (a norm overflow). Both screens drop the same uploads for the same reasons and
    count the same."""
    jscreen, tscreen = ji.UpdateScreen(), ti.UpdateScreen()
    tbefore = _counts(tregistry())
    jbefore = _counts(jregistry())
    for r in range(3):
        for c, flat in enumerate(_deltas(5, seed=10 * r)):
            if r == 1 and c == 2:
                flat["b"] *= 40.0
            if r == 2 and c == 3:
                flat = {k: v * 30.0 for k, v in flat.items()}
            jct, tct = _encode_pair("int8", flat, c, seed=r)
            if r == 1 and c == 1:
                jct, tct = corrupt_model_payload(jct, "nan"), port_corrupt(tct, "nan")
            want = jscreen.admit(c, r, jct)
            got = tscreen.admit(c, r, tct)
            assert (got is None) == (want is None), (r, c, got, want)
            if want is not None:
                assert got.split()[0] == want.split()[0], (got, want)
        jflag, tflag = jscreen.close_round(r), tscreen.close_round(r)
        assert sorted(tflag) == sorted(jflag), (r, tflag, jflag)
        assert tscreen.suspects() == jscreen.suspects()
    tdelta = {n: v - tbefore[n] for n, v in _counts(tregistry()).items()}
    jdelta = {n: v - jbefore[n] for n, v in _counts(jregistry()).items()}
    assert tdelta == jdelta
    assert tdelta["integrity/nonfinite_uploads"] == 1
    assert tdelta["integrity/z_outliers"] == 1
    assert tdelta["integrity/norm_overflows"] == 1


def test_quarantine_list_matches_reference():
    jq, tq = ji.QuarantineList(2), ti.QuarantineList(2)
    script = [("q", 1, 0), ("q", 2, 0), ("q", 1, 1), ("q", 1, 0), ("a", None, 1),
              ("a", None, 2), ("a", None, 3), ("f", None, 3), ("a", None, 4),
              ("q", 3, 4), ("f", None, 5), ("a", None, 8)]
    for op, client, r in script:
        if op == "q":
            assert tq.quarantine(client, r, "why") == jq.quarantine(client, r, "why")
        elif op == "a":
            assert tq.active(r) == jq.active(r)
        else:
            assert tq.filter_selection([1, 2, 3, 4], r) == jq.filter_selection(
                [1, 2, 3, 4], r)
        for c in (1, 2, 3):
            assert tq.is_quarantined(c, r) == jq.is_quarantined(c, r)
            assert tq.reason(c) == jq.reason(c)


def test_acceptance_guard_and_rollback_budget_match_reference():
    ok = {"w": np.ones((2, 2), np.float32)}
    bad = {"w": np.array([[1.0, np.nan], [0.0, 0.0]], np.float32)}
    for args in ({}, {"min_history": 3}, {"loss_mult": 1.5, "max_rollbacks": 1}):
        jg, tg = ji.AcceptanceGuard(**args), ti.AcceptanceGuard(**args)
        for params, loss in [(ok, 1.0), (ok, 0.8), (bad, 0.7), (ok, float("nan")),
                             (None, 5.0), (ok, 0.9), (ok, 3.0), (ok, "x")]:
            jp = None if params is None else _jt(params)
            tp = None if params is None else _tt(params)
            want, got = jg.check(jp, loss), tg.check(tp, loss)
            assert got == want
            if want is None:
                jg.accept(loss)
                tg.accept(loss)
            assert tg._loss_ewma == jg._loss_ewma
        raised = []
        for g in (jg, tg):
            try:
                for i in range(5):
                    g.record_rollback(3, "spike")
            except RuntimeError as e:  # both budgets' exception types
                raised.append((type(e).__name__, i, str(e)))
        assert raised[0] == raised[1]
    assert issubclass(ti.RollbackBudgetExceeded, RuntimeError)


@pytest.mark.parametrize("n", [3, 4, 5, 10])
@pytest.mark.parametrize("spec", ["median", "trimmed_mean@0.1", "trimmed_mean@0.2",
                                  "trimmed_mean@0.45"])
def test_fused_robust_sum_matches_reference(spec, n):
    """One poisoned client (×50) among ``n``; int8 deltas on the same keys
    (the reference's wire bytes). Within 1e-6 of the aggregate's scale."""
    flats = _deltas(n, seed=3)
    flats[1] = {k: v * 50.0 for k, v in flats[1].items()}
    pairs = [_encode_pair("int8", f, c) for c, f in enumerate(flats)]
    mode, trim = ti.parse_robust_spec(spec)
    assert (mode, trim) == ji.parse_robust_spec(spec)
    assert trim_k(n, trim) == ji.robust_agg.trim_k(n, trim)
    got = ti.fused_robust_sum([t for _, t in pairs], mode, trim)
    want = ji.fused_robust_sum([j for j, _ in pairs], mode, trim)
    for k in got:
        w = np.asarray(want[k])
        bound = 1e-6 * max(1e-2, float(np.abs(w).max()))
        assert float(np.abs(got[k].numpy() - w).max()) <= bound, k


@pytest.mark.parametrize("mode,trim", [("median", 0.0), ("trimmed_mean", 0.2)])
@pytest.mark.parametrize("n", [5, 6])
def test_fused_robust_equals_the_defenses_on_full_models(mode, trim, n):
    """Shift equivariance: the statistic of identity deltas plus the base
    equals the trimmed-mean / median defense of the full client models,
    in the port and in the reference."""
    from fedml_tpu_torch.core.security.defense.coord_median import (
        CoordinateWiseMedianDefense,
    )
    from fedml_tpu_torch.core.security.defense.trimmed_mean import TrimmedMeanDefense

    flats = _deltas(n)
    base = {k: np.float32(0.5) + v for k, v in flats[0].items()}
    models = [(10, {k: _tt(base)[k] + _tt(d)[k] for k in d}) for d in flats]
    cts = [tc.get_codec("identity").encode(_tt(d), is_delta=True) for d in flats]
    fused = tc.tree_undelta(_tt(base), ti.fused_robust_sum(cts, mode, trim))
    import types

    args = types.SimpleNamespace(beta=trim)
    defense = (CoordinateWiseMedianDefense(args) if mode == "median"
               else TrimmedMeanDefense(args))
    ref = defense.defend_on_aggregation(models, None)
    jfused = jc.codecs.tree_undelta(_jt(base), ji.fused_robust_sum(
        [jc.get_codec("identity").encode(_jt(d), is_delta=True) for d in flats],
        mode, trim))
    for k in ref:
        assert float((fused[k] - ref[k]).abs().max()) <= 1e-6, k
        assert float(np.abs(fused[k].numpy() - np.asarray(jfused[k])).max()) <= 1e-6, k


@pytest.mark.parametrize("mode", ["median", "trimmed_mean"])
def test_masked_robust_leaf_matches_reference(mode):
    from fedml_tpu.integrity.robust_agg import masked_robust_leaf as jmasked

    rng = np.random.default_rng(0)
    dec = rng.normal(size=(8, 5, 3)).astype(np.float32)
    for valid in ([1] * 8, [1, 1, 0, 1, 1, 1, 0, 1], [1, 0, 1, 1, 0, 0, 0, 0]):
        v = np.asarray(valid, bool)
        for trim in (0.1, 0.35, 0.45):
            got = masked_robust_leaf(torch.from_numpy(dec), torch.from_numpy(v), mode, trim)
            want = jmasked(jnp.asarray(dec), jnp.asarray(v), mode, trim)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def _port_cts(codec, n=3, **kw):
    return [tc.get_codec(codec).encode(_tt(f), key=tc.derive_key(0, 0, c), **kw)
            for c, f in enumerate(_deltas(n))]


def _masked_cts(n=3):
    """``n`` secure-aggregation uploads (zero masks: only the codec matters)."""
    from fedml_tpu_torch.privacy import secagg

    codec = tc.get_codec(f"secagg_int8@0.1/{secagg.client_bound(n)}/8")
    zeros = [np.zeros(sh, np.uint8) for _, sh in sorted(LEAVES)]  # leaf order
    return [secagg.masked_encode(_tt(f), zeros, codec, tc.derive_key(0, 0, c))[0]
            for c, f in enumerate(_deltas(n))]


REFUSALS = {
    "empty": (lambda: ti.fused_robust_sum([], "median"), ValueError, "empty"),
    "unknown mode": (lambda: ti.fused_robust_sum(_port_cts("int8", is_delta=True), "mean"),
                     ValueError, "unknown robust"),
    "heterogeneous codecs": (lambda: ti.fused_robust_sum(
        _port_cts("int8", 2, is_delta=True) + _port_cts("bf16", 1, is_delta=True),
        "median"), ValueError, "heterogeneous"),
    "delta and full": (lambda: ti.fused_robust_sum(
        _port_cts("int8", 2, is_delta=True) + _port_cts("int8", 1), "median"),
        ValueError, "heterogeneous"),
    "top-k": (lambda: ti.fused_robust_sum(_port_cts("topk", is_delta=True), "median"),
              ValueError, "dense per-coordinate"),
    "leaf count": (lambda: ti.fused_robust_sum(_truncated(), "median"), ValueError,
                   "leaf count"),
    "non-finite scale": (lambda: ti.fused_robust_sum(
        [port_corrupt(c, "nan") for c in _port_cts("int8", is_delta=True)], "median"),
        ValueError, "non-finite"),
    "mesh": (lambda: ti.fused_robust_sum(_port_cts("int8", is_delta=True), "median",
                                         mesh=object()), NotImplementedError, "A11"),
    "masked codec": (lambda: ti.fused_robust_sum(_masked_cts(), "median"), ValueError,
                     "masks hide"),
    "bad spec": (lambda: ti.parse_robust_spec("trimmed_mean@0.6"), ValueError, "trim"),
    "median parameter": (lambda: ti.parse_robust_spec("median@0.1"), ValueError,
                         "no parameter"),
    "agg_compressed robust with clip": (lambda: TAgg.agg_compressed(
        None, [(1, c) for c in _port_cts("int8", is_delta=True)], _tt(_deltas(1)[0]),
        clip_factors=[1.0, 1.0, 1.0], agg_robust="median"), ValueError, "norm-clip"),
    "agg_compressed full models": (lambda: TAgg.agg_compressed(
        None, [(1, c) for c in _port_cts("int8")], _tt(_deltas(1)[0]),
        agg_robust="median"), ValueError, "delta-encoded"),
    "agg_compressed plain trees": (lambda: TAgg.agg_compressed(
        None, [(1, _tt(f)) for f in _deltas(2)], _tt(_deltas(1)[0])), ValueError,
        "CompressedTree"),
    "agg_compressed empty": (lambda: TAgg.agg_compressed(None, [], {}), ValueError,
                             "empty"),
}


def _truncated():
    cts = _port_cts("int8", is_delta=True)
    cts[2].arrays = cts[2].arrays[:-1]
    return cts


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals(case):
    fn, exc, match = REFUSALS[case]
    with pytest.raises(exc, match=match):
        fn()


def test_agg_compressed_clip_factors_and_robust_match_reference():
    """Clip factors scale the weights without renormalizing; agg_robust
    swaps in the robust statistic — each within 1e-6 of the reference."""
    flats = _deltas(4, seed=9)
    pairs = [_encode_pair("int8", f, c) for c, f in enumerate(flats)]
    base = _deltas(1, seed=99, scale=1.0)[0]
    jraw = [(10 + c, j) for c, (j, _) in enumerate(pairs)]
    traw = [(10 + c, t) for c, (_, t) in enumerate(pairs)]
    for kw in ({"clip_factors": [1.0, 0.5, 0.25, 1.0]}, {"agg_robust": "trimmed_mean@0.25"},
               {"agg_robust": "median"}, {}):
        want = JAgg.agg_compressed(None, jraw, _jt(base), **kw)
        got = TAgg.agg_compressed(None, traw, _tt(base), **kw)
        for k in got:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6,
                                       atol=1e-7)


def test_integrity_config_reads_the_reference_names_and_defaults():
    import types

    for ns in ({}, {"integrity": True}, {"integrity_screen": True},
               {"integrity": True, "integrity_rollback": False, "max_rollbacks": 5,
                "quarantine_rounds": 4, "integrity_norm_mult": 3.0}):
        a = types.SimpleNamespace(**ns)
        want, got = ji.IntegrityConfig(a), ti.IntegrityConfig(a)
        assert vars(got) == vars(want)
        assert (ti.IntegrityConfig.from_args(a) is None) == (
            ji.IntegrityConfig.from_args(a) is None)
