"""The port's chaos injector against the reference's
(``tests/test_resilience.py``'s chaos tests mirrored, on the CPU):

* for the same spec, seed and message sequence the port's ``ChaosInjector``
  makes the reference's drop, duplicate, delay and partition decisions bit
  for bit (both hash through ``policy._unit_hash``); ``ChaosSpec`` parsing
  and the kill window, in both directions, match;
* ``corrupt_model_payload`` corrupts the same elements by the same factor on
  int8, identity and plain wire trees;
* ``ServerKillWindow`` reads the same spec from the args and from
  ``FEDML_CHAOS_KILL_SERVER``, and its kill is a SIGKILL;
* ``run_chaos_scenario`` over the port's in-process federation beside the
  reference's: a duplicate and delay storm, a client killed for a round
  window (quorum, eviction, rejoin), a NaN upload contained by the integrity
  rings — the same counters, and the same accuracy within 1e-5;
* ``python -m fedml_tpu_torch.cli chaos`` prints one JSON line, in process
  and with ``--kill-server``; the scheduler tier's options raise naming A13.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fedml_tpu.compression import codecs as jc
from fedml_tpu.core.distributed.message import Message as JMessage
from fedml_tpu.resilience import chaos as jchaos
from fedml_tpu.utils import serialization as jser
from fedml_tpu_torch.core.distributed.message import Message
from fedml_tpu_torch.resilience import chaos as tchaos
from fedml_tpu_torch.utils import serialization as tser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _msgs(cls, sender, receivers, rounds):
    out = []
    for i, rnd in enumerate(rounds):
        m = cls("MSG_T", sender, receivers[i % len(receivers)])
        if rnd is not None:
            m.add_params("round", rnd)
        out.append(m)
    return out


SPECS = [
    ({"drop": 0.3, "duplicate": 0.2}, 42),
    ({"drop": 0.3, "duplicate": 0.2}, 43),
    ({"duplicate": 0.4, "delay_ms": 2}, 3),
    ({"delay_ms": 5, "delay": 0.5, "drop": 0.05}, 7),
    ({"kill": {"rank": 2, "round": 2, "revive_round": 4}, "drop": 0.1}, 0),
    ({"partition": {"ranks": [1, 2], "round": 1, "heal_round": 3}}, 9),
]


@pytest.mark.parametrize("spec,seed", SPECS)
@pytest.mark.parametrize("rank", [0, 2])
def test_chaos_decisions_match_reference_bit_for_bit(spec, seed, rank):
    """300 sends to three peers over rounds 0..5 (and a header-less tail
    that reads the provider's round): the same (copies, delay) per send and
    the same inbound verdicts."""
    rounds = [i // 50 for i in range(300)] + [None] * 20
    peers = [p for p in (0, 1, 2, 3) if p != rank][:3]
    tinj = tchaos.ChaosInjector(tchaos.ChaosSpec(spec, seed=seed), rank,
                                round_provider=lambda: 2)
    jinj = jchaos.ChaosInjector(jchaos.ChaosSpec(spec, seed=seed), rank,
                                round_provider=lambda: 2)
    got = [tinj.on_send(m) for m in _msgs(Message, rank, peers, rounds)]
    want = [jinj.on_send(m) for m in _msgs(JMessage, rank, peers, rounds)]
    assert got == want
    inbound = [(p, r) for p in peers for r in (None, 0, 1, 2, 3, 4, 5)]
    tin = [tinj.on_deliver(_msgs(Message, p, [rank], [r])[0]) for p, r in inbound]
    jin = [jinj.on_deliver(_msgs(JMessage, p, [rank], [r])[0]) for p, r in inbound]
    assert tin == jin


def test_chaos_decisions_replay_bit_identically():
    runs = []
    for _ in range(2):
        inj = tchaos.ChaosInjector(tchaos.ChaosSpec({"drop": 0.3, "duplicate": 0.2},
                                                    seed=42), rank=0)
        runs.append([inj.on_send(Message("MSG_T", 0, 1)) for _ in range(200)])
    assert runs[0] == runs[1]
    drops = sum(1 for copies, _ in runs[0] if copies == 0)
    assert 30 <= drops <= 90 and any(copies == 2 for copies, _ in runs[0])
    other = tchaos.ChaosInjector(tchaos.ChaosSpec({"drop": 0.3, "duplicate": 0.2},
                                                  seed=43), rank=0)
    assert [other.on_send(Message("MSG_T", 0, 1)) for _ in range(200)] != runs[0]


def test_chaos_kill_window_drops_both_directions_by_round():
    spec = tchaos.ChaosSpec({"kill": {"rank": 2, "round": 2, "revive_round": 4}})
    inj = tchaos.ChaosInjector(spec, rank=0, round_provider=lambda: 2)

    def msg(sender, receiver, rnd=None):
        m = Message("MSG_T", sender, receiver)
        if rnd is not None:
            m.add_params("round", rnd)
        return m

    assert inj.on_send(msg(0, 2, rnd=2)) == (0, 0.0)
    assert inj.on_send(msg(0, 2, rnd=4))[0] == 1
    assert inj.on_send(msg(0, 1, rnd=2))[0] == 1
    assert not inj.on_deliver(msg(2, 0, rnd=3))
    assert inj.on_deliver(msg(2, 0, rnd=4))
    assert inj.on_send(msg(0, 2)) == (0, 0.0)  # no header: the provider's round
    assert inj.on_deliver(msg(1, 0))


def _spec_fields(spec):
    if spec is None:
        return None
    return (spec.seed, spec.drop, spec.duplicate, spec.delay_ms, spec.delay,
            spec.partitions, spec.any_probabilistic,
            [(w.rank, w.round, w.until, w.mode, w.factor, w.tier)
             for w in spec.corrupt_updates])


@pytest.mark.parametrize("raw", [
    None, "", False, json.dumps({"drop": 0.1}), {"delay_ms": 20},
    {"kill": {"rank": 3, "round": 1}, "partition": {"ranks": [1, 2], "round": 2}},
    {"corrupt_update": {"rank": 2, "round": 1, "mode": "nan"}},
    {"corrupt_update": [{"rank": 1, "round": 0, "until": 3, "factor": 8.0}]},
])
def test_chaos_spec_parsing_matches_reference(raw):
    assert _spec_fields(tchaos.ChaosSpec.parse(raw, seed=5)) == _spec_fields(
        jchaos.ChaosSpec.parse(raw, seed=5))


def test_chaos_spec_refusals_match_reference():
    for raw in ([1, 2], {"corrupt_update": {"rank": 1, "mode": "flip"}}):
        with pytest.raises(ValueError):
            jchaos.ChaosSpec.parse(raw)
        with pytest.raises(ValueError):
            tchaos.ChaosSpec.parse(raw)


# -- payload corruption -------------------------------------------------------------

def _trees():
    rng = np.random.default_rng(0)
    return {"params": {"Conv_0": {"kernel": rng.standard_normal((3, 3, 2, 4)).astype(np.float32),
                                  "bias": rng.standard_normal(4).astype(np.float32)},
                       "Dense_0": {"kernel": rng.standard_normal((8, 5)).astype(np.float32)}}}


@pytest.mark.parametrize("payload", ["int8", "identity", "plain"])
@pytest.mark.parametrize("mode", ["nan", "scale"])
def test_corrupt_model_payload_matches_reference(payload, mode):
    tree = _trees()
    if payload == "plain":
        jp = tree
        tp = tser.safe_loads(jser.safe_dumps(tree))  # the same wire tree as tensors
    else:
        jp = jc.get_codec(payload).encode(jax.tree.map(jnp.asarray, tree),
                                          key=jc.derive_key(0, 1, 2), is_delta=True)
        tp = tser.safe_loads(jser.safe_dumps(jp))
    jout = jchaos.corrupt_model_payload(jp, mode, factor=50.0)
    tout = tchaos.corrupt_model_payload(tp, mode, factor=50.0)
    # through each package's wire: the same bytes (NaN included)
    assert tser.safe_dumps(tout) == jser.safe_dumps(jout)
    if payload != "plain":
        assert tout is not tp and tp.arrays[0][0] is not tout.arrays[0][0]


def test_server_kill_window_spec_from_args_and_env(monkeypatch):
    import types

    args = types.SimpleNamespace(chaos=json.dumps({"kill_server": {"round": 3,
                                                                   "after_uploads": 2}}))
    for mod in (tchaos, jchaos):
        w = mod.ServerKillWindow.from_args(args)
        assert (w.round, w.after_uploads) == (3, 2)
    monkeypatch.setenv("FEDML_CHAOS_KILL_SERVER", json.dumps({"round": 1}))
    for mod in (tchaos, jchaos):
        w = mod.ServerKillWindow.from_args(types.SimpleNamespace())
        assert (w.round, w.after_uploads) == (1, 1)
        w.maybe_kill(0, 5)  # another round: nothing happens
        w.maybe_kill(1, 0)  # too few uploads: nothing happens


def test_server_kill_window_fires_a_sigkill():
    code = ("from fedml_tpu_torch.resilience import ServerKillWindow\n"
            "ServerKillWindow(2, 1).maybe_kill(2, 1)\n"
            "print('survived')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == -9 and "survived" not in proc.stdout


# -- the scenarios, beside the reference's ------------------------------------------

def _both(**kw):
    from fedml_tpu.resilience import run_chaos_scenario as jrun
    from fedml_tpu_torch.core.dp.fedml_differential_privacy import (
        FedMLDifferentialPrivacy,
    )
    from fedml_tpu_torch.core.security.attacker import FedMLAttacker
    from fedml_tpu_torch.core.security.defender import FedMLDefender

    ref = jrun(**kw)
    try:
        got = tchaos.run_chaos_scenario(device="cpu", **kw)
    finally:
        for singleton in (FedMLAttacker, FedMLDefender, FedMLDifferentialPrivacy):
            singleton.reset()
    assert got["completed"] and ref["completed"]
    assert got["chaos"] == ref["chaos"]
    assert got["result"]["rounds"] == ref["result"]["rounds"]
    return got, ref


def test_chaos_smoke_duplicates_absorbed_like_reference():
    """A seeded duplicate and delay storm: the same injections and the same
    duplicates dropped as the reference's run, and the same accuracy."""
    got, ref = _both(seed=3, rounds=3, clients=3, duplicate=0.4, delay_ms=2,
                     round_deadline_s=30.0)
    assert got["counters"]["duplicates_dropped"] > 0
    assert got["counters"] == ref["counters"]
    assert abs(got["result"]["test_acc"] - ref["result"]["test_acc"]) <= 1e-5
    assert got["result"]["test_acc"] > 0.4


def test_chaos_killed_client_quorum_and_rejoin_like_reference():
    """Client 2 killed for round 2: the round closes at quorum, 2 is evicted,
    rejoins, and the run finishes — the reference's counters."""
    got, ref = _both(seed=7, rounds=5, clients=3, kill_rank=2, kill_round=2,
                     compression="int8", round_deadline_s=5.0)
    for k in ("quorum_rounds", "clients_evicted", "clients_rejoined"):
        assert got["counters"][k] == ref["counters"][k] == 1, (k, got, ref)
    assert got["result"]["test_acc"] > 0.4


def test_chaos_nan_upload_contained_like_reference():
    """A NaN-corrupted int8 upload at the comm seam: the integrity screen
    drops it and quarantines its sender in both packages."""
    got, ref = _both(seed=1, rounds=3, clients=3, corrupt_rank=2, corrupt_round=1,
                     corrupt_mode="nan", compression="int8", integrity=True)
    for k in ("nonfinite_uploads", "quarantined"):
        assert got["counters"][k] == ref["counters"][k] == 1, (k, got, ref)


def _cli(*argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    return subprocess.run([sys.executable, "-m", "fedml_tpu_torch.cli", "chaos",
                           "--device", "cpu", *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("argv", [
    ("--seed", "3", "--rounds", "2", "--duplicate", "0.4"),
    ("--kill-server", "--seed", "5", "--rounds", "2", "--clients", "2",
     "--kill-round", "1"),
])
def test_cli_chaos_prints_one_json_line(argv):
    proc = _cli(*argv)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["completed"] is True
    if "--kill-server" in argv:
        assert out["restarts"] == 1 and out["salvaged_uploads"] >= 1
        assert out["digest"] and out["mttr_s"] is not None


def test_cli_chaos_scheduler_tier_raises_naming_a13():
    from fedml_tpu_torch import cli

    for flag in ("--drain", "--agent-kill"):
        with pytest.raises(NotImplementedError, match="A13"):
            cli.main(["chaos", "--device", "cpu", flag])
    with pytest.raises(ValueError, match="secagg"):
        cli.main(["chaos", "--device", "cpu", "--kill-server", "--secagg", "int8"])
