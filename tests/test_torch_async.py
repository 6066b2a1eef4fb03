"""The port's asynchronous cross-silo server and FedBuff buffer against the
reference's (``tests/test_hierarchy.py``'s FedBuff and async tests and
``tests/test_algorithms.py``'s async run mirrored, on the CPU):

* ``staleness_weight`` is the reference's function;
* a τ=0 flush of plain models is the sample-weighted FedAvg of them (within
  1e-6, the reference's bound), and the same as the JAX flush (within 1e-6);
* a flush of int8 deltas is bit-identical under shuffled arrival orders, and
  the JAX flush of the same deltas and staleness within the fused sum's
  stated bound (``tests/test_torch_codecs.py``: 1e-6 of the result's
  magnitude); a compressed full model is refused;
* three rounds of fresh int8+EF deltas in a K=N buffer track synchronous
  FedAvg within 2% (the reference's compression tolerance);
* the in-process async federation (instant apply, with int8 deltas, and
  FedBuff) completes its budget with the reference's counts and accuracy;
  a top-k compressed full model is refused loudly;
* the aggregation tree's names (ROADMAP A10.3c) resolve to the port's own.
"""
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedml_tpu
import fedml_tpu_torch
from fedml_tpu import arguments as jarguments
from fedml_tpu.compression import codecs as jc
from fedml_tpu.hierarchy import fedbuff as jfedbuff
from fedml_tpu.utils import serialization as jser
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch.compression import ErrorFeedback, derive_key, get_codec, tree_delta
from fedml_tpu_torch.hierarchy import FedBuffBuffer, staleness_weight
from fedml_tpu_torch.utils import serialization as tser

FUSED_TOL = 1e-6  # the fused weighted sum's bound in tests/test_torch_codecs.py


def test_staleness_weight_matches_reference():
    for tau in (0, 1, 2, 3, 7, 11, 100, -1):
        for exponent in (0.5, 0.9, 1.0):
            assert staleness_weight(tau, exponent) == jfedbuff.staleness_weight(tau, exponent)
    assert staleness_weight(0) == 1.0
    ws = [staleness_weight(t) for t in range(12)]
    assert all(a > b for a, b in zip(ws, ws[1:]))


def test_fedbuff_tau0_flush_equals_synchronous_fedavg_and_reference():
    rng = np.random.default_rng(0)
    g = {"w": np.zeros((6, 3), np.float32)}
    models = [{"w": rng.normal(size=(6, 3)).astype(np.float32)} for _ in range(3)]
    ns = [100.0, 300.0, 600.0]
    buf, jbuf = FedBuffBuffer(3), jfedbuff.FedBuffBuffer(3)
    for i, (m, n) in enumerate(zip(models, ns)):
        buf.add(sender=i + 1, base_version=0, n_samples=n,
                payload={"w": torch.from_numpy(m["w"])})
        jbuf.add(sender=i + 1, base_version=0, n_samples=n, payload=m)
    assert buf.full
    new_global, stats = buf.flush(current_version=0,
                                  global_params={"w": torch.from_numpy(g["w"])})
    jnew, jstats = jbuf.flush(current_version=0, global_params=g)
    want = sum((n / 1000.0) * m["w"] for m, n in zip(models, ns))
    np.testing.assert_allclose(new_global["w"].numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(new_global["w"].numpy(), np.asarray(jnew["w"]),
                               rtol=0, atol=1e-6)
    assert stats == jstats and stats["staleness"] == [0, 0, 0] and len(buf) == 0


def _int8_contribs(port):
    """Five int8 deltas at staleness 0..2, as the reference's trees or the
    port's (the same wire content)."""
    rng = np.random.default_rng(1)
    out = []
    for i in range(5):
        delta = {"w": rng.normal(size=(8, 4)).astype(np.float32),
                 "b": rng.normal(size=(4,)).astype(np.float32)}
        ct = jc.get_codec("int8").encode(jax.tree.map(jnp.asarray, delta),
                                         key=jc.derive_key(0, 0, i + 1), is_delta=True)
        out.append(dict(sender=i + 1, base_version=i % 3, n_samples=50.0 * (i + 1),
                        payload=tser.safe_loads(jser.safe_dumps(ct)) if port else ct))
    return out


def test_fedbuff_flush_deterministic_under_arrival_order_shuffles():
    contribs = _int8_contribs(port=True)
    g = {"w": torch.zeros(8, 4), "b": torch.zeros(4)}

    def flush_in(order):
        buf = FedBuffBuffer(5)
        for j in order:
            buf.add(**contribs[j])
        new_global, _ = buf.flush(current_version=4, global_params=g)
        return new_global

    base = flush_in(range(5))
    for seed in range(4):
        order = list(range(5))
        random.Random(seed).shuffle(order)
        got = flush_in(order)
        assert all(torch.equal(base[k], got[k]) for k in base), order


def test_fedbuff_int8_flush_matches_reference():
    """The same int8 deltas, staleness and sample counts: the port's flush
    (its fused weighted sum) is the JAX flush within the fused sum's bound,
    with the same staleness, senders and weights."""
    g = np.random.default_rng(2).normal(size=(8, 4)).astype(np.float32)
    gb = np.zeros(4, np.float32)
    buf, jbuf = FedBuffBuffer(5), jfedbuff.FedBuffBuffer(5)
    for c in _int8_contribs(port=True):
        buf.add(**c)
    for c in _int8_contribs(port=False):
        jbuf.add(**c)
    got, stats = buf.flush(4, {"w": torch.from_numpy(g), "b": torch.from_numpy(gb)})
    want, jstats = jbuf.flush(4, {"w": jnp.asarray(g), "b": jnp.asarray(gb)})
    assert stats == jstats
    assert stats["staleness"] == [4, 4, 3, 3, 2]
    for k in ("w", "b"):
        w = np.asarray(want[k])
        err = float(np.abs(got[k].numpy() - w).max())
        assert err <= FUSED_TOL * max(1.0, float(np.abs(w).max())), (k, err)


def test_fedbuff_rejects_compressed_full_model():
    ct = get_codec("int8").encode({"w": torch.ones(4)}, key=derive_key(0, 0, 1),
                                  is_delta=False)
    with pytest.raises(ValueError, match="FULL model"):
        FedBuffBuffer(2).add(sender=1, base_version=0, n_samples=1.0, payload=ct)


def test_fedbuff_3round_parity_with_sync_fedavg_int8():
    """Three rounds where every client's int8+EF delta lands fresh in a K=N
    buffer track synchronous FedAvg within 2%: the buffered path is FedAvg
    when nothing is stale."""
    rng = np.random.default_rng(3)
    codec = get_codec("int8")
    w_sync = np.zeros((12, 6), np.float32)
    w_buff = torch.zeros(12, 6)
    ns = [100.0, 250.0, 650.0]
    efs = [ErrorFeedback(codec) for _ in ns]
    target = (np.arange(72, dtype=np.float32) / 72.0).reshape(12, 6)
    for r in range(3):
        updates = [w_sync + 0.5 * (target - w_sync)
                   + 0.05 * rng.standard_normal((12, 6)).astype(np.float32) for _ in ns]
        mean = sum((n / sum(ns)) * u for u, n in zip(updates, ns))
        buf = FedBuffBuffer(3)
        for i, (u, n) in enumerate(zip(updates, ns)):
            local = torch.from_numpy(u - w_sync) + w_buff
            delta = tree_delta({"w": local}, {"w": w_buff})
            buf.add(sender=i + 1, base_version=r, n_samples=n,
                    payload=efs[i].encode(delta, key=derive_key(3, r, i + 1)))
        new, stats = buf.flush(current_version=r, global_params={"w": w_buff})
        assert stats["staleness"] == [0, 0, 0]
        w_buff, w_sync = new["w"], mean.astype(np.float32)
    num = float(np.linalg.norm(w_buff.numpy() - w_sync))
    assert num / max(float(np.linalg.norm(w_sync)), 1e-9) < 0.02


# -- the async server, end to end ------------------------------------------------------

def _async_cfg(run_id, **over):
    cfg = {
        "common_args": {"training_type": "cross_silo", "random_seed": 0, "run_id": run_id},
        "data_args": {"dataset": "synthetic", "train_size": 400, "test_size": 100,
                      "class_num": 4, "feature_dim": 12},
        "model_args": {"model": "lr"},
        "train_args": {"federated_optimizer": "FedAvg", "async_aggregation": True,
                       "async_total_updates": 9, "client_num_in_total": 3,
                       "client_num_per_round": 3, "comm_round": 3, "epochs": 1,
                       "batch_size": 32, "learning_rate": 0.3},
    }
    cfg["train_args"].update(over)
    return cfg


def _run_async(run_id, **over):
    from fedml_tpu_torch.cross_silo.run_inproc import run_cross_silo_inproc
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    args = fedml_tpu_torch.init(targuments.load_arguments_from_dict(_async_cfg(run_id, **over)))
    ds = load_federated(args)
    return run_cross_silo_inproc(args, ds, create(args, ds.class_num), timeout=120,
                                 device="cpu")


def _run_jax_async(run_id, **over):
    from fedml_tpu import models as jmodels
    from fedml_tpu.cross_silo.run_inproc import run_cross_silo_inproc
    from fedml_tpu.data import load_federated

    args = fedml_tpu.init(jarguments.load_arguments_from_dict(_async_cfg(run_id, **over)))
    ds = load_federated(args)
    return run_cross_silo_inproc(args, ds, jmodels.create(args, ds.class_num), timeout=120)


def test_async_fedavg_cross_silo_like_reference():
    """The reference's async run (tests/test_algorithms.py): 12 updates at
    alpha 0.6 over 3 silos; the same budget, a staleness and a sender per
    update, and an accuracy above the reference's floor like its own. The
    interleaving is the threads' schedule, so the numbers are held to the
    reference's bounds, not to its run."""
    over = dict(async_total_updates=12, async_alpha=0.6, comm_round=4)
    res = _run_async("tasync", **over)
    ref = _run_jax_async("tasync_ref", **over)
    for r in (res, ref):
        assert r["updates"] == 12 and r["versions"] == 12 and r["flushes"] == 0
        assert len(r["staleness"]) == len(r["senders"]) == 12
        assert set(r["senders"]) <= {1, 2, 3}
        assert r["test_acc"] > 0.5, r


def test_async_accepts_compressed_deltas_on_instant_path():
    res = _run_async("tasync_int8_instant", compression="int8")
    assert res["updates"] == 9 and res["flushes"] == 0
    assert res["test_acc"] > 0.5, res


def test_async_fedbuff_end_to_end_converges():
    """Async server + FedBuff(K=3) + int8 deltas: the budget in whole-buffer
    flushes, and convergence (arrival order is the threads', so the check is
    convergence; the buffer's determinism is held above)."""
    res = _run_async("tasync_fedbuff", compression="int8", async_buffer_size=3)
    assert res["updates"] == 9 and res["flushes"] == 3 and res["versions"] == 3
    assert res["test_acc"] > 0.5 and res["test_loss"] < 1.0, res


def test_async_refuses_topk_full_model_loudly():
    from fedml_tpu_torch.core.distributed.message import Message
    from fedml_tpu_torch.cross_silo.message_define import MyMessage
    from fedml_tpu_torch.cross_silo.server.async_server_manager import (
        AsyncFedMLServerManager,
    )

    args = fedml_tpu_torch.init(targuments.load_arguments_from_dict(
        _async_cfg("tasync_topk_refuse", compression="topk")))
    for buffer_size in (0, 3):
        args.async_buffer_size = buffer_size
        mgr = AsyncFedMLServerManager(args, aggregator=None, client_num=3)
        ct = get_codec("topk", args).encode({"w": torch.ones(64)}, key=derive_key(0, 0, 1),
                                            is_delta=False)
        msg = Message(MyMessage.MSG_TYPE_C2S_SEND_MODEL_TO_SERVER, 1, 0)
        msg.add_params(MyMessage.MSG_ARG_KEY_MODEL_PARAMS, ct)
        msg.add_params(MyMessage.MSG_ARG_KEY_NUM_SAMPLES, 10)
        msg.add_params(MyMessage.MSG_ARG_KEY_ROUND, 0)
        with pytest.raises(ValueError, match="compressed FULL model"):
            mgr.handle_client_update(msg)
        assert mgr.applied == 0
        mgr.finish()


@pytest.mark.parametrize("name", ["TreeTopology", "EdgeAggregator", "PartialSum",
                                  "TreeRunner", "reduce_cohort"])
def test_aggregation_tree_raises_naming_a10_3c(name):
    """ROADMAP A10.3c has landed: the names it refused now resolve to the
    port's own tree (held against the reference's in
    ``tests/test_torch_hierarchy.py``), and the package no longer raises for
    them; an unknown name is still an AttributeError."""
    import fedml_tpu_torch.hierarchy as hierarchy
    from fedml_tpu import hierarchy as jhierarchy

    obj = getattr(hierarchy, name)
    assert obj.__module__.startswith("fedml_tpu_torch.hierarchy.")
    assert obj.__name__ == getattr(jhierarchy, name).__name__
    with pytest.raises(AttributeError):
        getattr(hierarchy, "NoSuchTreeName")
