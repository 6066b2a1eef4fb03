"""The port's finite-field secure aggregation (``fedml_tpu_torch/core/mpc``
and the Bonawitz and LightSecAgg FSMs in ``cross_silo``) against the
reference's on the CPU, mirroring ``tests/test_mpc.py``'s ten cases: field
quantization, the tree ↔ field vector in the reference's order and layout,
LCC (the port's C++ library against its numpy twin and against the
reference, bit for bit), Shamir sharing, the Bonawitz and LightSecAgg
rounds, and both in-process protocols, one with a dropout."""
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu import arguments as jarguments
from fedml_tpu.core.mpc import finite as jfinite
from fedml_tpu.core.mpc import lcc as jlcc
from fedml_tpu.core.mpc import lightsecagg as jlsa
from fedml_tpu.core.mpc import secagg as jsa
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch.core.mpc import finite, lcc, lightsecagg, secagg
from fedml_tpu_torch.models.convert import from_flax_params

P = finite.DEFAULT_PRIME


def test_quantize_roundtrip_matches_the_reference():
    x = np.random.default_rng(0).normal(0, 3, 1000).astype(np.float32)
    x[:5] = [-2.5, -1e-4, 0.0, 3.25, 100.0]
    q = finite.quantize(x)
    assert np.array_equal(q, jfinite.quantize(x))
    assert np.array_equal(finite.dequantize(q), jfinite.dequantize(q))
    assert np.allclose(finite.dequantize(q), x, atol=2 ** -15)
    assert finite.modular_inv(12345) == jfinite.modular_inv(12345)
    assert np.array_equal(finite.mulmod(q, q), jfinite.mulmod(q, q))


def test_tree_finite_matches_the_reference_order_and_layout():
    """A port tree (a convolution kernel in OIHW) flattens to the field
    vector the reference builds from the same flax tree (HWIO), and back."""
    rng = np.random.default_rng(1)
    flax = {"params": {"Conv_0": {"kernel": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                                  "bias": rng.normal(size=(4,)).astype(np.float32)},
                       "Dense_0": {"kernel": rng.normal(size=(8, 3)).astype(np.float32)}}}
    port = from_flax_params(flax)
    flat, template = finite.tree_to_finite(port)
    jflat, _ = jfinite.tree_to_finite(flax)
    assert np.array_equal(flat, jflat)
    back = finite.finite_to_tree(flat, template)
    for k, v in port.items():
        assert back[k].shape == v.shape
        assert torch.allclose(back[k], v, atol=1e-4)


def test_lcc_native_numpy_and_reference_agree_bit_for_bit():
    rng = np.random.default_rng(0)
    K, T, N, dim = 3, 2, 8, 64
    betas = np.arange(1, K + T + 1, dtype=np.int64)
    alphas = np.arange(K + T + 1, K + T + 1 + N, dtype=np.int64)
    X = rng.integers(0, P, size=(K + T, dim)).astype(np.int64)
    coded = lcc.lcc_encode(X, betas, alphas, P)
    assert np.array_equal(coded, lcc.lcc_encode(X, betas, alphas, P, use_native=False))
    assert np.array_equal(coded, jlcc.lcc_encode(X, betas, alphas, P, use_native=False))
    surv = np.array([1, 2, 4, 6, 7])
    assert np.array_equal(lcc.lcc_decode(coded[surv], alphas[surv], betas, P), X)
    U = lcc.gen_lagrange_coeffs(alphas[surv], betas, P)
    assert np.array_equal(U, lcc.gen_lagrange_coeffs(alphas[surv], betas, P,
                                                     use_native=False))
    assert np.array_equal(U, jlcc.gen_lagrange_coeffs(alphas[surv], betas, P,
                                                      use_native=False))
    assert np.array_equal(lcc.field_matmul(U, coded[surv], P),
                          lcc.field_matmul(U, coded[surv], P, use_native=False))
    with pytest.raises(ValueError, match="distinct"):
        lcc.gen_lagrange_coeffs(np.array([1, 1]), betas, P)


def test_native_lcc_builds_into_the_port_build_dir(tmp_path, monkeypatch):
    """The port's own C++ library builds with the host compiler into
    ``build/fedml_tpu_torch/`` (never into ``native/``); a source that does
    not compile raises with the compiler's message."""
    from fedml_tpu_torch.ops import _build

    assert lcc.native_available()
    path = _build.library_path("lcc", ".cpp", _build.CXX_FLAGS)
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "fedml_tpu_torch")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "out")
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="failed to build broken"):
        _build.build_host("broken")


def test_shamir_share_reconstruct_matches_the_reference():
    secret = np.random.default_rng(1).integers(0, P, size=32).astype(np.int64)
    shares = secagg.shamir_share(secret, n_shares=7, threshold=3,
                                 rng=np.random.default_rng(2))
    assert np.array_equal(shares, jsa.shamir_share(secret, n_shares=7, threshold=3,
                                                   rng=np.random.default_rng(2)))
    assert np.array_equal(secagg.shamir_reconstruct(shares[[0, 2, 4, 6]], [1, 3, 5, 7]),
                          secret)
    # fewer than threshold + 1 shares do not reconstruct
    assert not np.array_equal(secagg.shamir_reconstruct(shares[[0, 2]], [1, 3]), secret)
    parts = secagg.additive_share(secret, 4, rng=np.random.default_rng(3))
    assert np.array_equal(parts.sum(0) % P, secret)


def test_secagg_round_with_dropout_matches_the_reference():
    """Seeded clients draw the reference's keys (``kx_keygen`` through the
    port's X25519), masks and shares; the server strips every mask and
    gives the survivors' exact sum."""
    n, t, dim = 5, 2, 40
    rng = np.random.default_rng(2)
    xs = {i: rng.integers(0, 1000, size=dim).astype(np.int64) for i in range(n)}
    clients = [secagg.SecAggClient(i, n, t, dim, seed=3) for i in range(n)]
    jclients = [jsa.SecAggClient(i, n, t, dim, seed=3) for i in range(n)]
    assert [c.pk for c in clients] == [c.pk for c in jclients]
    pks = {c.id: c.pk for c in clients}
    for c, jc in zip(clients, jclients):
        c.set_peer_keys(pks)
        jc.set_peer_keys(pks)
        assert c.pairwise == jc.pairwise
    shares = {c.id: c.self_seed_shares() for c in clients}
    for c, jc in zip(clients, jclients):
        assert np.array_equal(shares[c.id], jc.self_seed_shares())
    masked = {c.id: c.mask(xs[c.id]) for c in clients}
    for c, jc in zip(clients, jclients):
        assert np.array_equal(masked[c.id], jc.mask(xs[c.id]))
    dropped = 3
    survivors = [i for i in range(n) if i != dropped]
    kwargs = dict(masked={i: masked[i] for i in survivors},
                  self_seed_shares={i: {h: shares[i][h] for h in survivors}
                                    for i in survivors},
                  dropped_pairwise={dropped: {i: clients[i].pairwise_seed(dropped)
                                              for i in survivors}})
    agg = secagg.SecAggServer(n, t, dim).aggregate(**kwargs)
    assert np.array_equal(agg, jsa.SecAggServer(n, t, dim).aggregate(**kwargs))
    assert np.array_equal(agg, sum(xs[i] for i in survivors) % P)


def test_lightsecagg_end_to_end_matches_the_reference():
    n, u, t, dim = 6, 4, 1, 50  # K = U - T = 3 chunks
    rng = np.random.default_rng(4)
    xs = {i: rng.integers(0, 1000, size=dim).astype(np.int64) for i in range(n)}
    masks = {i: rng.integers(0, P, size=dim).astype(np.int64) for i in range(n)}
    coded = {i: lightsecagg.mask_encoding(dim, n, u, t, P, masks[i],
                                          np.random.default_rng(100 + i)) for i in range(n)}
    for i in range(n):
        want = jlsa.mask_encoding(dim, n, u, t, P, masks[i], np.random.default_rng(100 + i))
        assert all(np.array_equal(coded[i][j], want[j]) for j in range(n))
    received = {j: {i: coded[i][j] for i in range(n)} for j in range(n)}
    survivors = [0, 1, 3, 4, 5]
    uploads = [lightsecagg.model_masking(xs[i], masks[i], P) for i in survivors]
    agg_masked = lightsecagg.aggregate_models_in_finite(uploads, P)
    points = {j: lightsecagg.compute_aggregate_encoded_mask(received[j], P, survivors)
              for j in survivors}
    agg_mask = lightsecagg.decode_aggregate_mask(points, dim, n, u, t, P)
    assert np.array_equal(agg_mask, jlsa.decode_aggregate_mask(points, dim, n, u, t, P))
    assert np.array_equal(np.mod(agg_masked - agg_mask, P),
                          sum(xs[i] for i in survivors) % P)


def _mpc_cfg(run_id, **train):
    return {"common_args": {"training_type": "cross_silo", "random_seed": 0,
                            "run_id": run_id},
            "data_args": {"dataset": "synthetic", "train_size": 300, "test_size": 80,
                          "class_num": 4, "feature_dim": 12},
            "model_args": {"model": "lr"},
            "train_args": {"federated_optimizer": "FedAvg", "client_num_in_total": 4,
                           "client_num_per_round": 4, "comm_round": 2, "epochs": 1,
                           "batch_size": 32, "learning_rate": 0.3, **train}}


def _port_protocol(cfg, build, init):
    """The port's federation of ``build`` from the reference's initial
    weights, run to completion: (result, server manager, the silos' field
    vectors as masked in the last round, the server's unmasked sums)."""
    from fedml_tpu_torch.core.distributed.communication.local_comm import LocalBroker
    from fedml_tpu_torch.cross_silo.run_inproc import run_managers_to_completion
    from fedml_tpu_torch.data.data_loader import load_federated
    from fedml_tpu_torch.models.model_hub import create

    args = targuments.load_arguments_from_dict(cfg)
    ds = load_federated(args)
    LocalBroker.destroy(args.run_id)
    server, clients = build(args, ds, create(args, ds.class_num), "cpu")
    server.aggregator.set_global_model_params(from_flax_params(init))
    sums = []
    unmask_sum = server.unmask_sum
    server.unmask_sum = lambda *a: sums.append(unmask_sum(*a)) or sums[-1]
    result = run_managers_to_completion([server] + clients, args.run_id,
                                        "MSG_TYPE_CONNECTION_IS_READY", timeout=120)
    return result, server, sums


def _jax_init(cfg):
    import jax

    from fedml_tpu import models as jmodels
    from fedml_tpu.data import load_federated
    from fedml_tpu.models import model_hub

    args = fedml_tpu.init(jarguments.load_arguments_from_dict(cfg))
    ds = load_federated(args)
    model = jmodels.create(args, ds.class_num)
    return args, ds, model, jax.tree.map(
        np.asarray, model_hub.init_params(model, args, ds.train_data_global[0][:32]))


def test_lightsecagg_inproc_protocol_matches_the_reference():
    """The LightSecAgg FSMs over LOCAL: the server sees only masked uploads,
    and its unmasked model tests as the reference's does."""
    from fedml_tpu.cross_silo.lightsecagg import run_lightsecagg_inproc as jrun
    from fedml_tpu_torch.cross_silo.lightsecagg.run_inproc import build_lightsecagg_inproc

    jargs, jds, jmodel, init = _jax_init(_mpc_cfg("jax_lsa"))
    want = jrun(jargs, jds, jmodel, timeout=120)
    got, server, sums = _port_protocol(_mpc_cfg("torch_lsa"), build_lightsecagg_inproc,
                                       init)
    assert got["rounds"] == want["rounds"] == 2 and len(sums) == 2
    assert got["test_acc"] == want["test_acc"] > 0.4
    assert abs(got["test_loss"] - want["test_loss"]) <= 1e-4


def test_secagg_client_refuses_overlapping_reconstruction():
    """A client named both survivor and dropped reveals nothing; one reveal
    a round."""
    from fedml_tpu_torch.core.distributed.message import Message
    from fedml_tpu_torch.cross_silo.secagg.sa_client_manager import SAClientManager
    from fedml_tpu_torch.cross_silo.secagg.sa_message_define import SAMessage as M

    mgr = object.__new__(SAClientManager)
    mgr.rank, mgr.round_idx = 1, 0
    mgr.sa = secagg.SecAggClient(client_id=1, n_clients=3, threshold=1, dim=4)
    mgr.sa.set_peer_keys({2: secagg.SecAggClient(2, 3, 1, 4).pk,
                          3: secagg.SecAggClient(3, 3, 1, 4).pk})
    mgr.held_shares = {1: np.zeros(2, np.int64), 2: np.zeros(2, np.int64)}
    mgr.reconstruction_answered = False
    sent = []
    mgr.send_message = sent.append
    mgr.get_sender_id = lambda: 1

    def request(survivors, dropped):
        msg = Message(M.MSG_TYPE_S2C_REQUEST_RECONSTRUCTION, 0, 1)
        msg.add_params(M.MSG_ARG_KEY_SURVIVORS, survivors)
        msg.add_params(M.MSG_ARG_KEY_DROPPED, dropped)
        msg.add_params(M.MSG_ARG_KEY_ROUND, 0)
        mgr.handle_reconstruction(msg)

    request([1, 2], [2, 3])  # 2 overlaps
    assert sent == []
    request([1, 2], [3])
    assert len(sent) == 1
    assert set(sent[0].get(M.MSG_ARG_KEY_SELF_SHARES)) == {1, 2}
    assert set(sent[0].get(M.MSG_ARG_KEY_PAIRWISE_SEEDS)) == {3}
    request([1], [2])  # a second request, disjoint on its own
    assert len(sent) == 1


def test_secagg_inproc_protocol_with_dropout_matches_the_reference():
    """The Bonawitz FSMs over LOCAL with rank 3 dropping after the key and
    share exchange of round 0: the server's unmasked field sum is exactly
    the survivors' (count-weighted) field vectors' sum, and the global model
    after each round is the reference's within one fixed-point step
    (2^-15: the silos' float training may round a word the other way)."""
    from fedml_tpu.cross_silo.secagg import run_secagg_inproc as jrun
    from fedml_tpu_torch.core.mpc.secagg import SecAggClient
    from fedml_tpu_torch.cross_silo.secagg.run_inproc import build_secagg_inproc

    cfg = dict(sa_simulate_dropout_rank=3)
    jargs, jds, jmodel, init = _jax_init(_mpc_cfg("jax_sa", **cfg))
    want = jrun(jargs, jds, jmodel, timeout=120)
    inputs = []
    mask = SecAggClient.mask
    SecAggClient.mask = lambda self, x: inputs.append((self.id, np.array(x))) or mask(self, x)
    try:
        got, server, sums = _port_protocol(_mpc_cfg("torch_sa", **cfg), build_secagg_inproc,
                                           init)
    finally:
        SecAggClient.mask = mask
    assert got["rounds"] == want["rounds"] == 2 and len(sums) == 2
    # round 0: ranks 1, 2, 4 masked (3 dropped); round 1: all four
    assert sorted(r for r, _ in inputs[:3]) == [1, 2, 4]
    for rnd, lo, hi in ((0, 0, 3), (1, 3, 7)):
        assert np.array_equal(sums[rnd], sum(x for _, x in inputs[lo:hi]) % P)
    jfinal = from_flax_params(want["global_model"])
    for k, v in got["global_model"].items():
        assert torch.allclose(v, jfinal[k], rtol=0, atol=2.0 ** -15), k
    assert got["test_acc"] > 0.4
