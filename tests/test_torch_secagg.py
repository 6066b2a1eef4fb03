"""The port's masked secure aggregation (``fedml_tpu_torch/privacy/secagg``
and its cross-silo wiring, ``secagg: int8``) against the reference's on the
CPU, on the same numpy inputs:

* the X25519 ladder against ``cryptography`` and the reference's keys;
* the masks, the recovery adjustment, the masked encode's words and
  residual, the unmask and the masked wire bytes, bit for bit at
  ``mod_bits`` 4, 8 and 16 (with DP noise within 2e-5·σ: the twin's
  ``erfinv`` is not XLA's); the encode's scale as the reference's jitted
  program rounds it;
* the codec's guards, the v2 wire's hostile and truncated payloads, the
  session guards (mirroring ``tests/test_secagg.py``);
* ``secagg: int8`` federations run by both packages: three rounds on LR,
  a stalled silo closing a round through the seed-reveal recovery, every
  compatibility refusal, and mixed federations over one broker (a JAX
  server with port silos, and a port server with JAX silos).
"""
import copy
import json
import struct
import threading
import time

import jax
import numpy as np
import pytest
import torch

import fedml_tpu
from fedml_tpu import arguments as jarguments
from fedml_tpu.compression import derive_key as jderive_key
from fedml_tpu.compression import get_codec as jget_codec
from fedml_tpu.privacy import secagg as js
from fedml_tpu.privacy.secagg import keys as jkeys
from fedml_tpu.privacy.secagg import masking as jm
from fedml_tpu.utils.serialization import safe_dumps as jdumps
from fedml_tpu.utils.serialization import safe_loads as jloads
from fedml_tpu_torch import arguments as targuments
from fedml_tpu_torch import compression as tc
from fedml_tpu_torch.privacy import secagg as ts
from fedml_tpu_torch.privacy.secagg import keys as tkeys
from fedml_tpu_torch.privacy.secagg import masking as tm
from fedml_tpu_torch.utils.serialization import safe_dumps as tdumps
from fedml_tpu_torch.utils.serialization import safe_loads as tloads

import test_torch_cross_silo as cs

MOD_BITS = (4, 8, 16)
# leaves named as the port's trees are (the reference's leaf order sorts
# them the same way), one of them a convolution kernel in the reference's
# HWIO layout
SHAPES = {"params/Conv_0/kernel": (3, 3, 4, 5), "params/Dense_0/bias": (7,),
          "params/Dense_0/kernel": (33, 7)}
META = tuple(("float32", sh) for _, sh in sorted(SHAPES.items()))
SECRETS = {(1, 2): 1009, (1, 3): 2029, (1, 4): 3037, (2, 3): 4049, (2, 4): 5059,
           (3, 4): 6067}


def _jtree(tree):
    """A flat ``{path: array}`` tree as the reference's nested dict."""
    out = {}
    for path, v in tree.items():
        node = out
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return out


def _ttree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _flat_j(tree):
    """The reference's nested output → ``{path: numpy}``."""
    from fedml_tpu_torch.models.convert import flatten_paths

    return {k: np.asarray(v) for k, v in flatten_paths(tree).items()}


def _deltas(n, scale=0.05, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: rng.normal(0, scale, sh).astype(np.float32) for k, sh in SHAPES.items()}
            for _ in range(n)]


def _seeds(rank, n, round_idx):
    return {j: tm.pair_round_seed(SECRETS[min(rank, j), max(rank, j)], round_idx)
            for j in range(1, n + 1) if j != rank}


def _encode_both(deltas, mod_bits, round_idx=0, residuals=None):
    """Each client's masked upload from both packages (same masks, keys,
    residuals): ``[(jax_ct, jax_res, port_ct, port_res)]``."""
    n = len(deltas)
    spec = f"secagg_int8@0.1/{tm.client_bound(n, mod_bits)}/{mod_bits}"
    out = []
    for i, d in enumerate(deltas, start=1):
        mask = tm.net_mask_leaves(i, _seeds(i, n, round_idx), META, mod_bits)
        sa = {"round": round_idx, "rank": i, "roster": list(range(1, n + 1))}
        res = None if residuals is None else residuals[i - 1]
        jct, jres = js.masked_encode(_jtree(d), mask, jget_codec(spec),
                                     jderive_key(0, round_idx, i),
                                     residual=None if res is None else _jtree(res), sa=sa)
        tct, tres = ts.masked_encode(_ttree(d), mask, tc.get_codec(spec),
                                     tc.derive_key(0, round_idx, i),
                                     residual=None if res is None else _ttree(res), sa=sa)
        out.append((jct, _flat_j(jres), tct, tres))
    return out, spec


# -- keys -----------------------------------------------------------------------------
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_x25519_ladder_matches_cryptography_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    sk_a, sk_b = rng.bytes(32), rng.bytes(32)
    pk_a = tkeys.public_key(sk_a, ladder=True)
    assert pk_a == tkeys.public_key(sk_a, ladder=False)
    pk_b = tkeys.kx_keygen(sk_b)[1]
    secret = tkeys.kx_agree(sk_a, pk_b, ladder=True)
    assert secret == tkeys.kx_agree(sk_a, pk_b, ladder=False)
    assert secret == tkeys.kx_agree(sk_b, pk_a, ladder=True)
    assert secret == jkeys.kx_agree(sk_a, pk_b)
    assert 0 <= secret < 1 << 128


# -- masking, bit for bit -------------------------------------------------------------
def test_client_bound_and_pair_round_seed_match_the_reference():
    for n in (1, 2, 3, 4, 7, 31, 127, 128, 255):
        for mod_bits in MOD_BITS:
            try:
                want = jm.client_bound(n, mod_bits)
            except ValueError:
                with pytest.raises(ValueError):
                    tm.client_bound(n, mod_bits)
                continue
            assert tm.client_bound(n, mod_bits) == want
    with pytest.raises(ValueError):
        tm.client_bound(4, 12)
    for secret, r in ((0, 0), (1 << 127, 5), (123456789, -1)):
        assert tm.pair_round_seed(secret, r) == jm.pair_round_seed(secret, r)


@pytest.mark.parametrize("mod_bits", MOD_BITS)
def test_masks_and_recovery_adjustment_match_the_reference(mod_bits):
    for a, b in zip(tm.mask_leaves(99, META, mod_bits), jm.mask_leaves(99, META, mod_bits)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    net = [tm.net_mask_leaves(i, _seeds(i, 4, 2), META, mod_bits) for i in range(1, 5)]
    for i in range(1, 5):
        for a, b in zip(net[i - 1], jm.net_mask_leaves(i, _seeds(i, 4, 2), META, mod_bits)):
            assert np.array_equal(a, b)
    for leaves in zip(*net):  # the masks cancel exactly over the full roster
        total = sum(x.astype(np.int64) for x in leaves) % (1 << mod_bits)
        assert not total.any()
    pairs = [(1, 3, _seeds(1, 4, 2)[3]), (4, 3, _seeds(4, 4, 2)[3])]
    for a, b in zip(tm.recovery_adjustment(pairs, META, mod_bits),
                    jm.recovery_adjustment(pairs, META, mod_bits)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mod_bits", MOD_BITS)
def test_masked_encode_words_and_residual_match_the_reference(mod_bits):
    deltas = _deltas(3, seed=mod_bits)
    residuals = _deltas(3, scale=0.01, seed=mod_bits + 100)
    encoded, _ = _encode_both(deltas, mod_bits, round_idx=2, residuals=residuals)
    for jct, jres, tct, tres in encoded:
        assert tct.codec == "secagg_int8" and tct.version == 2 and tct.is_delta
        assert tct.meta == jct.meta and tct.raw_nbytes == jct.raw_nbytes
        for a, b in zip(jct.arrays, tct.arrays):
            assert np.asarray(a[0]).dtype == b[0].numpy().dtype
            assert np.array_equal(np.asarray(a[0]), b[0].numpy())
        for k in SHAPES:
            assert np.array_equal(jres[k], tres[k].numpy()), k


def test_masked_encode_scale_is_the_jitted_rounding():
    """Inside the reference's jitted encode the scale is a constant and XLA
    multiplies by its f32 reciprocal: on these 2^20 elements the port's
    product matches every word, while a true division moves one."""
    x = np.random.default_rng(0).normal(0, 0.03, (1 << 20,)).astype(np.float32)
    spec = f"secagg_int8@0.1/{tm.client_bound(4)}/8"
    mask = [np.zeros(x.shape, np.uint8)]
    jct, _ = js.masked_encode({"w": x}, mask, jget_codec(spec), jderive_key(0, 0, 1))
    tct, _ = ts.masked_encode({"w": torch.from_numpy(x)}, mask, tc.get_codec(spec),
                              tc.derive_key(0, 0, 1))
    want = np.asarray(jct.arrays[0][0])
    assert np.array_equal(tct.arrays[0][0].numpy(), want)
    from fedml_tpu_torch.compression import threefry

    codec = tc.get_codec(spec)
    u = threefry.uniform(threefry.fold_in(tc.derive_key(0, 0, 1), 0), x.shape)
    xc = torch.clamp(torch.from_numpy(x), -codec.clip, codec.clip)
    div = torch.clamp(torch.floor(xc / torch.tensor(np.float32(codec.scale)) + u),
                      -codec.bound, codec.bound).to(torch.int32) & 0xFF
    assert int((div.numpy() != want).sum()) >= 1


# -- the unmask -----------------------------------------------------------------------
@pytest.mark.parametrize("mod_bits", MOD_BITS)
def test_unmask_finalize_matches_the_reference_exactly(mod_bits):
    deltas = _deltas(4, seed=10 + mod_bits)
    encoded, spec = _encode_both(deltas, mod_bits, round_idx=1)
    base = _deltas(1, scale=1.0, seed=77)[0]
    jcodec, tcodec = jget_codec(spec), tc.get_codec(spec)
    want = _flat_j(js.unmask_finalize([e[0] for e in encoded], _jtree(base), jcodec))
    got = ts.unmask_finalize([e[2] for e in encoded], _ttree(base), tcodec)
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in SHAPES)
    # client 2 evicted: the survivors' reveals remove its dangling halves
    pairs = [(s, 2, _seeds(s, 4, 1)[2]) for s in (1, 3, 4)]
    rec = tm.recovery_adjustment(pairs, META, mod_bits)
    survivors = [encoded[i] for i in (0, 2, 3)]
    want = _flat_j(js.unmask_finalize([e[0] for e in survivors], _jtree(base), jcodec,
                                      recovery=rec))
    got = ts.unmask_finalize([e[2] for e in survivors], _ttree(base), tcodec, recovery=rec)
    assert all(np.array_equal(got[k].numpy(), want[k]) for k in SHAPES)
    # and that is the survivors' never-masked sum: their words with zero masks
    zeros = [np.zeros(sh, np.uint8) for _, sh in META]
    plain = [ts.masked_encode(_ttree(deltas[i]), zeros, tcodec, tc.derive_key(0, 1, i + 1))[0]
             for i in (0, 2, 3)]
    never = ts.unmask_finalize(plain, _ttree(base), tcodec)
    assert all(torch.equal(got[k], never[k]) for k in SHAPES)


def test_unmask_finalize_dp_noise_within_tolerance_of_the_reference():
    """Central DP's noise is drawn on the aggregate's device by the twin's
    ``normal``: within 2e-5·σ of the reference's draw; the trace records
    the pre-noise aggregate on the device and the noise added there."""
    deltas = _deltas(3, seed=5)
    encoded, spec = _encode_both(deltas, 8)
    base = _deltas(1, scale=1.0, seed=6)[0]
    sigma, key = 0.3, np.asarray([12345, 678], np.uint32)
    want = _flat_j(js.unmask_finalize([e[0] for e in encoded], _jtree(base),
                                      jget_codec(spec), dp_sigma=sigma, dp_key_data=key))
    got = ts.unmask_finalize([e[2] for e in encoded], _ttree(base), tc.get_codec(spec),
                             dp_sigma=sigma, dp_key_data=key)
    plain = ts.unmask_finalize([e[2] for e in encoded], _ttree(base), tc.get_codec(spec))
    for k in SHAPES:
        assert np.abs(got[k].numpy() - want[k]).max() <= 2e-5 * sigma
        assert not torch.equal(got[k], plain[k])
    trace = ts.last_finalize_trace()
    assert trace["pre_noise_on_device"] is True and trace["device"] == "cpu"


# -- the codec's guards ---------------------------------------------------------------
def test_masked_tree_decode_guards():
    from fedml_tpu_torch.telemetry.health import update_norm

    encoded, spec = _encode_both(_deltas(3), 8)
    codec, ct = tc.get_codec(spec), encoded[0][2]
    with pytest.raises(ValueError, match="refusing to decode"):
        codec.decode(ct)
    with pytest.raises(ValueError, match="mask cancellation"):
        tc.fused_weighted_sum([e[2] for e in encoded], np.ones(3, np.float32) / 3)
    assert update_norm(ct) is None
    with pytest.raises(ValueError, match="mask input"):
        codec.encode(_ttree(_deltas(1)[0]))
    with pytest.raises(ValueError, match="float-leaf"):
        ts.masked_encode({"n": torch.zeros(3, dtype=torch.int32)}, [np.zeros(3, np.uint8)],
                         codec, tc.derive_key(0, 0, 1))
    with pytest.raises(ValueError, match="net mask has"):
        ts.masked_encode(_ttree(_deltas(1)[0]), [], codec, tc.derive_key(0, 0, 1))
    with pytest.raises(ValueError, match="homogeneous"):
        ts.unmask_finalize([ct, tc.get_codec("int8").encode(_ttree(_deltas(1)[0]),
                                                             is_delta=True)],
                           _ttree(_deltas(1)[0]), codec)
    with pytest.raises(NotImplementedError, match="A11"):
        ts.unmask_finalize([ct], _ttree(_deltas(1)[0]), codec,
                           mesh=type("Mesh", (), {"size": 2})())
    from fedml_tpu_torch.integrity import screen_stats

    with pytest.raises(ValueError, match="screened"):
        screen_stats(ct)


@pytest.mark.parametrize("spec,match", [("secagg_int8@0/31/8", "clip"),
                                        ("secagg_int8@0.1/31", "malformed"),
                                        ("secagg_int8@0.1/x/8", "malformed"),
                                        ("secagg_int8@0.1/200/8", "not representable"),
                                        ("secagg_int8@0.1/3/12", "mod_bits")])
def test_malformed_specs_raise_as_in_the_reference(spec, match):
    with pytest.raises(ValueError, match=match):
        jget_codec(spec)
    with pytest.raises(ValueError, match=match):
        tc.get_codec(spec)


def test_secagg_modes():
    ns = type("A", (), {})
    for mode, on in (("", False), ("off", False), ("none", False), ("int8", True),
                     ("true", True)):
        a = ns()
        a.secagg = mode
        assert ts.secagg_enabled(a) is on is js.secagg_enabled(a)
    a = ns()
    a.secagg = "int4"
    with pytest.raises(ValueError, match="unknown secagg mode"):
        ts.secagg_enabled(a)
    with pytest.raises(ValueError, match="unknown secagg mode"):
        js.secagg_enabled(a)


# -- the v2 wire ----------------------------------------------------------------------
@pytest.mark.parametrize("mod_bits", MOD_BITS)
def test_masked_wire_bytes_equal_the_reference_and_load_both_ways(mod_bits):
    encoded, _ = _encode_both(_deltas(3, seed=mod_bits), mod_bits)
    for jct, _, tct, _ in encoded:
        payload = {"model_params": tct, "round": 0}
        jb, tb = jdumps({"model_params": jct, "round": 0}), tdumps(payload)
        assert jb == tb
        back, jback = tloads(jb)["model_params"], jloads(tb)["model_params"]
        assert back.sa == tct.sa == jback.sa and back.version == jback.version == 2
        assert back.structure == tct.structure
        for a, b, c in zip(back.arrays, tct.arrays, jback.arrays):
            assert torch.equal(a[0], b[0]) and np.array_equal(np.asarray(c[0]), b[0].numpy())


def test_masked_wire_fuzz_hostile_and_truncated():
    """Every malformed masked payload raises ValueError on both sides."""
    encoded, _ = _encode_both(_deltas(3), 8)
    wire = tdumps({"m": encoded[0][2]})
    for cut in list(range(0, 12)) + list(range(12, len(wire) - 1, 83)):
        for loads in (tloads, jloads):
            try:
                loads(wire[:cut])
            except ValueError:
                pass
    hostile = [
        {"skeleton": {"__codec__": "secagg_int8", "v": 2, "meta": [], "structure": [],
                      "state": []}, "arrays": []},
        {"skeleton": {"__codec__": "int8", "v": 1, "meta": [], "structure": [],
                      "state": [], "sa": {"rank": 1}}, "arrays": []},
        {"skeleton": {"__codec__": "int8", "v": 2, "meta": [], "structure": [],
                      "state": [], "sa": {"rank": 1}}, "arrays": []},
        {"skeleton": {"__codec__": "secagg_int8", "v": 2, "meta": [], "structure": [],
                      "state": [], "sa": [1, 2]}, "arrays": []},
        {"skeleton": {"__codec__": "secagg_int8", "v": 3, "meta": [], "structure": [],
                      "state": [], "sa": {}}, "arrays": []},
    ]
    for skel in hostile:
        header = json.dumps(skel).encode()
        payload = struct.pack("<I", len(header)) + header + b"\x00" * 32
        for loads in (tloads, jloads):
            with pytest.raises(ValueError):
                loads(payload)


# -- the session guards ---------------------------------------------------------------
def _targs(**train):
    return targuments.load_arguments_from_dict({"train_args": train},
                                               training_type="cross_silo")


def test_server_session_rejects_hostile_uploads_and_reveals():
    sess = ts.SecAggServerSession(_targs(secagg="int8", round_quorum=0.5), client_num=3)
    for cid in (1, 2, 3):
        sess.note_pk(cid, bytes(32))
    with pytest.raises(ValueError):
        sess.note_pk(1, b"short")
    header = sess.begin_round(0, [1, 2, 3])
    assert header["roster"] == [1, 2, 3] and header["spec"] == sess.codec.spec
    encoded, _ = _encode_both(_deltas(3, seed=1), 8)
    ct = encoded[0][2]
    sess.validate_upload(1, ct)
    with pytest.raises(ValueError, match="claims rank"):
        sess.validate_upload(2, ct)
    with pytest.raises(ValueError, match="masked upload"):
        sess.validate_upload(1, {"w": torch.zeros(3)})
    bad_round = copy.copy(ct)
    bad_round.sa = dict(ct.sa, round=7)
    with pytest.raises(ValueError, match="does not match"):
        sess.validate_upload(1, bad_round)
    no_sa = copy.copy(ct)
    no_sa.sa = None
    with pytest.raises(ValueError, match="sa header"):
        sess.validate_upload(1, no_sa)
    junk = copy.copy(ct)
    junk.sa = {"rank": "x", "round": 0, "roster": [1, 2, 3]}
    with pytest.raises(ValueError, match="malformed"):
        sess.validate_upload(1, junk)
    sess.begin_recovery([1, 2], [3])
    with pytest.raises(ValueError, match="non-survivor"):
        sess.note_reveal(3, {3: 1}, 0)
    with pytest.raises(ValueError, match="non-evicted"):
        sess.note_reveal(1, {2: 1}, 0)
    with pytest.raises(ValueError, match="int"):
        sess.note_reveal(1, {"x": "y"}, 0)
    with pytest.raises(ValueError, match="dict"):
        sess.note_reveal(1, [1, 2], 0)
    with pytest.raises(ValueError, match="unexpected"):
        sess.note_reveal(1, {3: 1}, 4)
    assert not sess.note_reveal(1, {3: 11}, 0)
    assert sess.pending_reveals() == [2]
    assert sess.note_reveal(2, {3: 22}, 0)
    assert sess.recovery_complete()
    with pytest.raises(RuntimeError, match="no key"):
        sess.begin_round(1, [1, 2, 9])


def test_client_session_reveal_guards():
    """The client refuses what a lying server would need: itself, peers
    outside the roster, another round, more dropouts than the quorum could
    lose, a malformed request; the refusals are counted as the reference
    counts them."""
    from fedml_tpu_torch.telemetry import get_registry

    args = _targs(secagg="int8", round_deadline_s=10.0, round_quorum=0.5)
    sessions = {r: ts.SecAggClientSession(r, args) for r in (1, 2, 3, 4)}
    header = {"v": 1, "spec": f"secagg_int8@0.1/{tm.client_bound(4)}/8",
              "roster": [1, 2, 3, 4], "pks": {r: s.pk for r, s in sessions.items()},
              "round": 2}
    s1 = sessions[1]
    s1.begin_round(header, 2)
    before = get_registry().counter("secagg/reveal_refusals").value
    assert s1.reveal_for([1], 2) is None
    assert s1.reveal_for([9], 2) is None
    assert s1.reveal_for([3], 5) is None
    assert s1.reveal_for([2, 3, 4], 2) is None
    assert s1.reveal_for("junk", 2) is None
    assert get_registry().counter("secagg/reveal_refusals").value - before == 5
    ok = s1.reveal_for([3], 2)
    assert set(ok) == {3}
    sessions[3].begin_round(header, 2)
    assert ok[3] == sessions[3]._peer_seeds[1]
    # one reveal per (round, peer): a second wave may extend, within the bound
    assert s1.reveal_for([2, 4], 2) is None
    for bad in ({"roster": [1]}, dict(header, spec="secagg_int8@0.1/99/8"),
                dict(header, roster=[2, 3, 4]), dict(header, roster=[1, 1, 2, 3]),
                dict(header, pks={2: b"x"}), "junk"):
        with pytest.raises(ValueError):
            s1.begin_round(bad, 2)


# -- federations ------------------------------------------------------------------------
def _sa_cfg(**train):
    return cs._cfg(**{"secagg": "int8", "secagg_clip": 0.2, **train})


def test_secagg_federation_matches_the_reference():
    """Three masked rounds of LR over 3 silos in each package from the same
    weights: the same silos, and per round the test metrics and the global
    parameters within the cross-silo tolerance (the unmask is exact)."""
    cfg = _sa_cfg()
    ref = cs._jax_fed(cfg)
    port = cs._port_fed(cfg, cs._jax_init(ref))
    seen = []
    add = port.server.fedml_aggregator.add_local_trained_result
    port.server.fedml_aggregator.add_local_trained_result = lambda i, p, n, local_steps=None: (
        seen.append((p.codec, p.version, p.sa["rank"])), add(i, p, n, local_steps))[1]
    assert cs._run_local(ref)["rounds"] == cs._run_local(port)["rounds"] == 3
    assert sorted(seen) == sorted(("secagg_int8", 2, r) for r in (1, 2, 3) for _ in range(3))
    cs._hold(port, ref, None)


class _SecAggStall:
    """Silo 3's round-0 training waits until the server has closed round 0
    (at quorum, then through the recovery); silos 1 and 2 wait in round 1
    until silo 3 has been re-synced, so the rejoin lands inside round 1 in
    both packages. The server's unmask and every client's encode inputs
    are recorded."""

    def __init__(self, fed, timeout=60.0):
        self.fed, self.unmasks, self.encodes, self.missing = fed, [], {}, []
        self.rejoined = threading.Event()
        smgr = fed.server.manager

        def wait(cond, what):
            end = time.monotonic() + timeout
            while not cond():
                assert time.monotonic() < end, what
                time.sleep(0.01)

        for c in fed.clients:
            mgr = c.manager
            trainer = mgr.trainer_dist_adapter.trainer
            run = trainer.run_local_training

            def gated(*a, mgr=mgr, run=run, **kw):
                if mgr.rank == 3 and mgr.round_idx == 0:
                    wait(lambda: smgr.args.round_idx >= 1, "round 0 never closed")
                if mgr.rank in (1, 2) and mgr.round_idx == 1:
                    wait(self.rejoined.is_set, "silo 3 never rejoined")
                return run(*a, **kw)

            trainer.run_local_training = gated
            if not fed.jax:
                sess = mgr._secagg

                def encode(delta, key, mgr=mgr, sess=sess, enc=sess.encode_update):
                    self.encodes[mgr.round_idx, mgr.rank] = (delta, key, sess._residual)
                    return enc(delta, key)

                sess.encode_update = encode
        mgr3 = fed.clients[2].manager
        rejoin = mgr3.handle_message_rejoin_sync

        def recorded_rejoin(msg):
            rejoin(msg)
            self.rejoined.set()

        # an instance attribute: the handler table is built from it at start
        mgr3.handle_message_rejoin_sync = recorded_rejoin
        finish = smgr._finish_round

        def recorded_finish(missing):
            self.missing.append(list(missing))
            return finish(missing)

        smgr._finish_round = recorded_finish
        if not fed.jax:
            session = smgr._secagg
            unmask = session.aggregate

            def recorded_unmask(cts, base):
                out = unmask(cts, base)
                self.unmasks.append((int(session.round_idx), list(cts), base, out))
                return out

            session.aggregate = recorded_unmask


def _counter_deltas(fed, names, before):
    if fed.jax:
        from fedml_tpu.telemetry import get_registry
    else:
        from fedml_tpu_torch.telemetry import get_registry
    return {n: get_registry().counter(n).value - before[n] for n in names}


def test_stalled_silo_round_recovers_bit_identical_to_the_survivors_sum():
    """Round 0 closes at quorum after its deadline with silo 3 stalled:
    silos 1 and 2 reveal their seeds with silo 3, and the recovered
    aggregate is bit-identical to their never-masked sum; the reveal
    counters and the per-round models match the reference's."""
    from fedml_tpu.telemetry import get_registry as jreg
    from fedml_tpu_torch.telemetry import get_registry as treg

    cfg = _sa_cfg(round_deadline_s=1.0, round_quorum=0.66)
    ref = cs._jax_fed(cfg)
    port = cs._port_fed(cfg, cs._jax_init(ref))
    stalls = [_SecAggStall(ref), _SecAggStall(port)]
    names = ("secagg/recoveries", "secagg/seeds_revealed", "secagg/rounds")
    counts = []
    for fed, reg in ((ref, jreg), (port, treg)):
        before = {n: reg().counter(n).value for n in names}
        assert cs._run_local(fed)["rounds"] == 3
        counts.append(_counter_deltas(fed, names, before))
    assert counts[0] == counts[1] == {"secagg/recoveries": 1, "secagg/seeds_revealed": 2,
                                      "secagg/rounds": 3}
    for s in stalls:
        assert s.missing[0] == [3], s.missing
    assert port.silos == ref.silos
    cs._hold(port, ref, None)
    rnd, cts, base, out = stalls[1].unmasks[0]
    assert rnd == 0 and [ct.sa["rank"] for ct in cts] == [1, 2]
    codec = tc.get_codec(f"secagg_int8@0.2/{tm.client_bound(3)}/8")
    plain = []
    for ct in cts:
        delta, key, res = stalls[1].encodes[0, ct.sa["rank"]]
        zeros = [np.zeros(sh, np.uint8) for _, sh in ct.meta]
        plain.append(ts.masked_encode(delta, zeros, codec, key, residual=res)[0])
    want = ts.unmask_finalize(plain, base, codec)
    assert all(torch.equal(out[k], want[k]) for k in want)


@pytest.mark.parametrize("side", ["jax", "port"])
def test_recovery_waves_evict_a_silent_survivor_then_abort(side):
    """Silo 4 misses the round; survivor 3 never reveals: the recovery
    deadline evicts it, drops its upload and re-asks 1 and 2 for both
    evicted peers; when the bounded waves run out the federation aborts
    through ``handler_error`` — the reference's behaviour, step for step."""
    cfg = _sa_cfg(client_num_in_total=4, client_num_per_round=4, round_deadline_s=30.0,
                  round_quorum=0.5, secagg_recovery_rounds=2)
    ref = cs._jax_fed(cfg)
    fed = ref if side == "jax" else cs._port_fed(cfg, cs._jax_init(ref))
    mgr = fed.server.manager
    sess = mgr._secagg
    for c in (1, 2, 3, 4):
        sess.note_pk(c, tkeys.kx_keygen()[1])
    mgr.is_initialized = True
    mgr.client_id_list_in_this_round = [1, 2, 3, 4]
    mgr.args.round_idx = 0
    sess.begin_round(0, [1, 2, 3, 4])
    deltas = _deltas(3)
    for i, d in enumerate(deltas):
        zeros = [np.zeros(sh, np.uint8) for _, sh in META]
        sa = {"round": 0, "rank": i + 1, "roster": [1, 2, 3, 4]}
        spec = sess.codec.spec
        ct = (js.masked_encode(_jtree(d), zeros, jget_codec(spec), jderive_key(0, 0, i + 1),
                               sa=sa)[0] if side == "jax" else
              ts.masked_encode(_ttree(d), zeros, tc.get_codec(spec), tc.derive_key(0, 0, i + 1),
                               sa=sa)[0])
        mgr.aggregator.add_local_trained_result(i, ct, 10)
    sent = []
    mgr.com_manager.send_message = sent.append
    mgr._finish_round([4])
    mgr._recovery_deadline.cancel()
    assert [(m.get_receiver_id(), m.get("secagg_evicted")) for m in sent] == [
        (1, [4]), (2, [4]), (3, [4])]
    for c in (1, 2):
        reveal = type(sent[0])("MSG_TYPE_C2S_SECAGG_REVEAL", c, 0)
        reveal.add_params("secagg_reveal", {4: 100 + c})
        reveal.add_params("round", 0)
        mgr.handle_message_secagg_reveal(reveal)
    assert sess.pending_reveals() == [3]
    sent.clear()
    mgr._on_recovery_deadline(0)
    mgr._recovery_deadline.cancel()
    assert sess.evicted == [3, 4] and sess.survivors == [1, 2]
    assert mgr.aggregator.n_received() == 2 and mgr.handler_error is None
    assert [(m.get_receiver_id(), m.get("secagg_evicted")) for m in sent] == [
        (1, [3, 4]), (2, [3, 4])]
    mgr._on_recovery_deadline(0)
    assert isinstance(mgr.handler_error, RuntimeError)
    assert "mask recovery stuck" in str(mgr.handler_error)


REFUSALS = {
    "agg_robust": ({"agg_robust": "median", "compression": "int8"}, ValueError,
                   "agg_robust"),
    "integrity screening": ({"integrity": True}, ValueError, "integrity screening"),
    "list defense": ({"enable_defense": True, "defense_type": "krum"}, ValueError,
                     "list-based defenses"),
    "model attack": ({"enable_attack": True, "attack_type": "byzantine",
                      "attack_mode": "random", "byzantine_client_num": 1}, ValueError,
                     "model-attack"),
    "upload codec": ({"compression": "topk"}, ValueError, "upload codec"),
    "laplace central DP": ({"enable_dp": True, "dp_solution_type": "CDP",
                            "mechanism_type": "laplace"}, ValueError, "non-gaussian"),
    "FHE": ({"enable_fhe": True}, NotImplementedError, "A13"),
    "contribution": ({"enable_contribution": True}, ValueError, "contribution assessment"),
    "unknown mode": ({"secagg": "int4"}, ValueError, "unknown secagg mode"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_secagg_compatibility_refusals(case):
    """Every per-client-plaintext feature is refused when the server is
    built, as in the reference (FHE is not ported and raises naming its
    item first)."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    over, exc, match = REFUSALS[case]
    cfg = _sa_cfg(**over)
    args = targuments.load_arguments_from_dict(cfg)
    try:
        with pytest.raises(exc, match=match):
            fedml_tpu_torch.init(args)
            ds = cs.tdl.load_federated(args)
            cs.Server(args, "cpu", ds, cs.thub.create(args, ds.class_num))
    finally:
        for singleton in (FedMLAttacker, FedMLDefender, FedMLDifferentialPrivacy):
            singleton.reset()


def test_secagg_federation_with_gaussian_central_dp_noises_on_the_device():
    """Gaussian central DP under secagg: the noise is drawn in the unmask on
    the aggregate's device, one accounted release a round."""
    import fedml_tpu_torch
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import FedMLDifferentialPrivacy
    from fedml_tpu_torch.telemetry import get_registry

    cfg = _sa_cfg(comm_round=2, enable_dp=True, dp_solution_type="CDP",
                  mechanism_type="gaussian", epsilon=50.0, delta=1e-5, sensitivity=0.01,
                  max_epsilon=1e9)
    FedMLDifferentialPrivacy.reset()
    try:
        fedml_tpu_torch.init(targuments.load_arguments_from_dict(copy.deepcopy(cfg)))
        before = get_registry().counter("secagg/dp_noise_rounds").value
        port = cs._port_fed(cfg, cs._jax_init(cs._jax_fed(_sa_cfg(comm_round=2))))
        assert cs._run_local(port)["rounds"] == 2
        assert get_registry().counter("secagg/dp_noise_rounds").value - before == 2
        assert FedMLDifferentialPrivacy.get_instance().epsilon_spent() > 0.0
        trace = ts.last_finalize_trace()
        assert trace["noised_in_program"] is True and trace["pre_noise_on_device"] is True
    finally:
        FedMLDifferentialPrivacy.reset()


@pytest.mark.parametrize("server_side", ["jax", "port"])
def test_mixed_secagg_federation_over_the_broker_matches_all_jax(server_side, tmp_path):
    """The slice's acceptance: one ``secagg: int8`` federation, two
    frameworks, masked bytes on a TCP broker — a JAX server unmasks port
    silos' uploads, and a port server JAX silos' — held to the all-JAX run."""
    ref = cs._jax_fed(_sa_cfg())
    init = cs._jax_init(ref)
    assert cs._run_local(ref)["rounds"] == 3
    broker = (cs.JBroker if server_side == "port" else cs.PubSubBroker)().start()
    try:
        host, bport = broker.address
        cfg = _sa_cfg(comm={"comm_backend": "BROKER", "broker_host": host,
                            "broker_port": bport, "object_store_dir": str(tmp_path),
                            "payload_offload_bytes": 64})
        jargs = fedml_tpu.init(jarguments.load_arguments_from_dict(copy.deepcopy(cfg)))
        targs = targuments.load_arguments_from_dict(copy.deepcopy(cfg))
        jds, tds = cs.jdl.load_federated(jargs), cs.tdl.load_federated(targs)
        jmodel, tmodel = cs.jhub.create(jargs, jds.class_num), cs.thub.create(targs,
                                                                             tds.class_num)
        if server_side == "jax":
            server = cs.JServer(jargs, None, jds, jmodel)
        else:
            server = cs.Server(targs, "cpu", tds, tmodel)
            server.fedml_aggregator.set_global_model_params(
                cs.from_flax_params(jax.tree.map(np.asarray, init)))
        clients = []
        for rank in (1, 2, 3):
            if server_side == "jax":
                a = copy.copy(targs)
                a.rank = rank
                clients.append(cs.Client(a, "cpu", tds, tmodel))
            else:
                a = copy.copy(jargs)
                a.rank = rank
                clients.append(cs.JClient(a, None, jds, jmodel))
        fed = cs.Fed(server, clients, jax_side=server_side == "jax")
        cs._run_threads(fed.managers)
    finally:
        broker.stop()
    assert fed.server.manager.result["rounds"] == 3
    cs._hold(fed, ref, None)


# -- the example on the port ------------------------------------------------------------
def test_secagg_multiprocess_example_config_runs_on_the_port(tmp_path):
    """``examples/federate/cross_silo/secagg_multiprocess/fedml_config.yaml``
    (Bonawitz, 3 silos, ``secagg_threshold: 2``) through the port's entry
    points, each rank on its own thread over one broker, on the CPU."""
    import os

    import yaml

    import fedml_tpu_torch
    from fedml_tpu_torch.core.distributed.communication.broker import PubSubBroker

    path = os.path.join(os.path.dirname(cs.__file__), "..", "examples", "federate",
                        "cross_silo", "secagg_multiprocess", "fedml_config.yaml")
    with open(path) as f:
        cfg = yaml.safe_load(f)
    broker = PubSubBroker().start()
    out, errors = {}, []
    try:
        host, port = broker.address
        cfg["common_args"]["run_id"] = "torch_sa_example"
        cfg["train_args"].update(broker_host=host, broker_port=port,
                                 object_store_dir=str(tmp_path / "store"))

        def run(rank):
            try:
                args = targuments.load_arguments_from_dict(copy.deepcopy(cfg))
                args.rank = rank
                fn = (fedml_tpu_torch.run_cross_silo_server if rank == 0
                      else fedml_tpu_torch.run_cross_silo_client)
                out[rank] = fn(args, device="cpu")
            except BaseException as e:  # noqa: BLE001 - reported below
                errors.append(e)

        threads = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(4)]
        for t in threads:
            t.start()
        end = time.monotonic() + 120
        for t in threads:
            t.join(max(0.0, end - time.monotonic()))
        assert not errors, errors
        assert not any(t.is_alive() for t in threads)
    finally:
        broker.stop()
    result = out[0]
    assert result["rounds"] == cfg["train_args"]["comm_round"] == 2
    assert result["test_acc"] > 0.5, result


# -- the aggregation tree: per-edge-cohort secagg --------------------------
def _uniform_delta_fns(meta):
    """Deltas ``(uniform - 0.5) / 4`` per leaf under ``fold_in(key, leaf)``:
    exact in f32 on both sides and inside the ±0.1 clip only in part."""
    from fedml_tpu_torch.compression import threefry

    shapes = [sh for _, sh in meta]

    def jfn(key):
        return tuple((jax.random.uniform(jax.random.fold_in(key, i), sh) - 0.5) * 0.25
                     for i, sh in enumerate(shapes))

    ids, sizes = list(range(len(shapes))), [int(np.prod(sh)) for sh in shapes]

    def tfn(keys):
        flat = (threefry.uniform_leaves(keys, ids, sizes) - 0.5) * 0.25
        out, off = [], 0
        for sh, n in zip(shapes, sizes):
            out.append(flat[:, off:off + n].reshape((keys.shape[0],) + tuple(sh)))
            off += n
        return tuple(out)

    return jfn, tfn


def test_tree_cohort_masked_sums_match_the_reference_word_for_word():
    """``tests/test_secagg.py``'s tree scenario on both packages: every
    cohort's unmasked sum, round by round — through the recovery after the
    kill — equals the reference's bit for bit; the recovered sum equals the
    survivors' quantized words summed with zero masks; two port runs end
    digest-identical."""
    from fedml_tpu.hierarchy import runner as jrunner
    from fedml_tpu.hierarchy.tree import TreeTopology as JTopology
    from fedml_tpu_torch.hierarchy import KillWindow, TreeRunner, TreeTopology
    from fedml_tpu_torch.hierarchy import runner as trunner
    from fedml_tpu_torch.telemetry import get_registry

    tmpl = jrunner.default_template(128)
    meta = tuple(("float32", tmpl[k].shape) for k in sorted(tmpl))  # b, w
    jfn, tfn = _uniform_delta_fns(meta)

    def record(runner, sink, port):
        for cohort in runner.cohorts:
            reduce = cohort.reduce

            def wrapped(r, alive, cohort=cohort, reduce=reduce):
                out = reduce(r, alive)
                leaves = [np.asarray(x) if not port else x.numpy() for x in out[0]]
                sink.append((r, cohort.edge_id, leaves, out[1], out[2]))
                if port and r == 1 and not np.asarray(alive).all():
                    live = np.nonzero(np.asarray(alive) & ~cohort.evicted_mask)[0]
                    plain = cohort.chunk_words(r, live, None)
                    sink.append(("plain", [torch.equal(a, b) for a, b in
                                           zip(cohort.last_words, plain)]))
                return out

            cohort.reduce = wrapped
        return runner

    kw = dict(codec="int8", seed=3, quorum=0.5, chunk=16, secagg=True)
    jsums, tsums = [], []
    before = get_registry().counter("secagg/hier_recoveries").value
    jr = record(jrunner.TreeRunner(JTopology([1, 2, 24]), template=tmpl, delta_fn=jfn,
                                   chaos=[jrunner.KillWindow(2, 5, 1)], **kw), jsums, False)
    jout = jr.run(3)
    t1 = record(TreeRunner(TreeTopology([1, 2, 24]), template=trunner.default_template(128),
                           delta_fn=tfn, chaos=[KillWindow(2, 5, 1)], device="cpu", **kw),
                tsums, True)
    tout = t1.run(3)
    assert get_registry().counter("secagg/hier_recoveries").value - before >= 1
    plain = [s for s in tsums if s[0] == "plain"]
    assert plain == [("plain", [True, True])]
    tsums = [s for s in tsums if s[0] != "plain"]
    assert len(tsums) == len(jsums) == 6
    for (jr_, je, jl, jw, jn), (tr_, te, tl, tw, tn) in zip(jsums, tsums):
        assert (jr_, je, jw, jn) == (tr_, te, tw, tn)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(a, b)
    assert tout["secagg"] is jout["secagg"] is True
    assert tout["root_total_weight"] == jout["root_total_weight"]
    again = TreeRunner(TreeTopology([1, 2, 24]), template=trunner.default_template(128),
                       delta_fn=tfn, chaos=[KillWindow(2, 5, 1)], device="cpu", **kw).run(3)
    assert again["final_digest"] == tout["final_digest"]


@pytest.mark.parametrize("option,match", [({"ef": True}, "EF"),
                                          ({"agg_robust": "median"}, "agg_robust"),
                                          ({"screen": True}, "screening"),
                                          ({"secagg_mod_bits": 4}, "mod_bits")])
def test_tree_secagg_refusals(option, match):
    from fedml_tpu_torch.hierarchy import TreeRunner, TreeTopology

    with pytest.raises(ValueError, match=match):
        TreeRunner(TreeTopology([1, 2, 24]), codec="int8", secagg=True, device="cpu",
                   **option)
