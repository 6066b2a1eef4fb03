"""The port's resilience pieces (``fedml_tpu_torch.resilience``) against the
reference's (``fedml_tpu.resilience``) on the same inputs: quorum sizes,
adaptive deadlines, the seeded retry delays, the deduper's decisions,
liveness bookkeeping, the resilience config, and round deadlines firing
(and not firing once re-armed or cancelled); and the comm manager's
receiver-side dedup and send retry, side by side."""
import threading
import time
import types

import numpy as np
import pytest

from fedml_tpu import resilience as J
from fedml_tpu.core.distributed.fedml_comm_manager import FedMLCommManager as JCommManager
from fedml_tpu.core.distributed.message import Message as JMessage
from fedml_tpu_torch import resilience as T
from fedml_tpu_torch.core.distributed.fedml_comm_manager import FedMLCommManager
from fedml_tpu_torch.core.distributed.message import Message


@pytest.mark.parametrize("expected", [1, 2, 3, 4, 7, 10, 64])
def test_quorum_size_is_the_reference(expected):
    for frac in (0.01, 0.1, 0.5, 0.66, 2 / 3, 0.75, 0.999, 1.0):
        assert T.quorum_size(expected, frac) == J.quorum_size(expected, frac)


def test_adaptive_deadline_is_the_reference():
    rng = np.random.default_rng(0)
    cases = [({}, 4.0, 0.5, 1.0, 30.0), ({1: 1.0, 2: 2.0, 3: 3.0}, 4.0, 0.5, 1.0, 30.0),
             ({1: 0.01}, 4.0, 0.1, 1.0, 30.0), ({1: 100.0}, 4.0, 0.5, 1.0, 30.0),
             ({1: 2.0, 2: 4.0}, 1.5, 0.3, 1.0, 0.0)]
    for _ in range(20):
        n = int(rng.integers(1, 9))
        ewma = {i: float(v) for i, v in enumerate(rng.exponential(2.0, n))}
        cases.append((ewma, float(rng.uniform(1, 6)), float(rng.uniform(0, 1)),
                      float(rng.uniform(0.1, 2)), float(rng.uniform(1, 60))))
    for c in cases:
        assert T.adaptive_deadline_s(*c) == J.adaptive_deadline_s(*c)


@pytest.mark.parametrize("seed,key", [(0, ""), (1, "k"), (7, "rank3"), (123, "broker:x")])
def test_retry_delays_are_the_reference(seed, key):
    for kw in ({}, {"max_attempts": 6, "base_delay_s": 0.01, "max_delay_s": 0.1},
               {"max_attempts": 1}, {"jitter": 0.0}):
        assert list(T.RetryPolicy(seed=seed, key=key, **kw).delays()) == list(
            J.RetryPolicy(seed=seed, key=key, **kw).delays())


def test_retry_call_retries_then_raises_like_the_reference():
    for mod in (J, T):
        calls, slept = [], []

        def flaky():
            calls.append(1)
            raise ConnectionError("down")

        with pytest.raises(ConnectionError):
            mod.RetryPolicy(max_attempts=3, seed=2).call(
                flaky, retry_on=(ConnectionError,), sleep=slept.append)
        assert len(calls) == 3
        if mod is J:
            want = slept
        else:
            assert slept == want


def test_deduper_decisions_are_the_reference():
    rng = np.random.default_rng(1)
    ids = [f"m{int(i)}" for i in rng.integers(0, 12, 300)]
    j, t = J.MessageDeduper(capacity=5), T.MessageDeduper(capacity=5)
    assert [t.seen(i) for i in ids] == [j.seen(i) for i in ids]
    assert (len(t), t.duplicates) == (len(j), j.duplicates)


def test_liveness_is_the_reference():
    j, t = J.PeerLiveness(silent_after_s=0.05), T.PeerLiveness(silent_after_s=0.05)
    for lv in (j, t):
        lv.note(1)
        lv.note(2)
    for step in [("evict", 1), ("evict", 1), ("is_evicted", 1), ("evicted", None),
                 ("readmit", 1), ("readmit", 1), ("is_evicted", 1), ("evict", 2),
                 ("evict", 3), ("evicted", None), ("readmit", 3), ("evicted", None)]:
        op, arg = step
        got = [getattr(lv, op)() if arg is None else getattr(lv, op)(arg)
               for lv in (j, t)]
        assert got[0] == got[1], (step, got)


@pytest.mark.parametrize("over", [{}, {"round_deadline_s": 5.0},
                                  {"round_deadline_s": 2, "round_quorum": 0.5,
                                   "round_deadline_adaptive": False,
                                   "heartbeat_interval_s": 1.5, "send_max_retries": 7},
                                  {"round_quorum": 0.9, "random_seed": 4}])
def test_resilience_config_is_the_reference(over):
    args = types.SimpleNamespace(**over)
    j, t = J.ResilienceConfig(args), T.ResilienceConfig(args)
    assert vars(t) == vars(j)
    assert t.deadline_enabled == j.deadline_enabled
    assert list(t.retry_policy("k").delays()) == list(j.retry_policy("k").delays())
    for bad in (0.0, 1.5):
        with pytest.raises(ValueError):
            T.ResilienceConfig(types.SimpleNamespace(round_quorum=bad))


def _fires(mod):
    """Arm, re-arm for a newer round, cancel, arm again: which rounds fire."""
    fired, lock = [], threading.Lock()

    def on_expire(r):
        with lock:
            fired.append(r)

    d = mod.RoundDeadline(on_expire)
    d.arm(0, 0.05)
    d.arm(1, 0.1)          # supersedes round 0's timer
    time.sleep(0.3)
    d.arm(2, 0.05)
    d.cancel()             # round 2 never fires
    d.arm(3, 0.0)          # a zero timeout arms nothing
    d.arm(4, 0.05)
    time.sleep(0.3)
    return fired


def test_round_deadline_fires_like_the_reference():
    assert _fires(T) == _fires(J) == [1, 4]


def _managers(mod_cls, msg_cls, run_id):
    args = types.SimpleNamespace(run_id=run_id, random_seed=0)
    got = []

    class Mgr(mod_cls):
        def register_message_receive_handlers(self):
            self.register_message_receive_handler("UPLOAD", lambda m: got.append(
                m.get("round")))

    tx, rx = Mgr(args, rank=1, size=2), Mgr(args, rank=0, size=2)
    rx.register_message_receive_handlers()
    return tx, rx, got, msg_cls


@pytest.mark.parametrize("side", ["reference", "port"])
def test_duplicate_upload_is_applied_once(side):
    """The same message delivered twice (a transport resend keeps its id)
    reaches the handler once; a new message with the same content does not
    count as a duplicate."""
    if side == "reference":
        tx, rx, got, msg_cls = _managers(JCommManager, JMessage, "dedup_ref")
    else:
        tx, rx, got, msg_cls = _managers(FedMLCommManager, Message, "dedup_port")
    m = msg_cls("UPLOAD", 1, 0).add_params("round", 0)
    tx.send_message(m)
    tx.com_manager.broker.post(0, m)   # the resend of the same logical message
    tx.send_message(msg_cls("UPLOAD", 1, 0).add_params("round", 1))
    rx.com_manager.pump()
    assert got == [0, 1]
    assert rx._deduper.duplicates == 1


def test_send_retries_a_transient_failure_with_the_same_id():
    args = types.SimpleNamespace(run_id="retry_port", random_seed=0, retry_base_s=0.001)
    mgr = FedMLCommManager(args, rank=1, size=2)
    sent, fail = [], [2]
    real = mgr.com_manager.send_message

    def flaky(msg):
        if fail[0]:
            fail[0] -= 1
            raise ConnectionError("blip")
        sent.append(msg.get(Message.MSG_ARG_KEY_MSG_ID))
        real(msg)

    mgr.com_manager.send_message = flaky
    mgr.send_message(Message("X", 1, 0))
    assert len(sent) == 1 and sent[0].endswith(":1:1")
    mgr.com_manager.send_message = lambda msg: (_ for _ in ()).throw(ConnectionError("down"))
    with pytest.raises(ConnectionError):
        mgr.send_message(Message("X", 1, 0))


def test_unported_resilience_options_raise_naming_their_item(tmp_path):
    """The journal, chaos and the server-kill window are ported: each is
    None without its argument and builds with it (the journal refuses a
    missing checkpoint_dir, as the reference does); the scheduler tier's
    chaos still raises, naming its item."""
    assert T.chaos_from_args(types.SimpleNamespace(), 0) is None
    assert T.journal_from_args(types.SimpleNamespace()) is None
    assert T.ServerKillWindow.from_args(types.SimpleNamespace()) is None
    assert isinstance(T.chaos_from_args(types.SimpleNamespace(chaos={"drop": 0.1}), 1),
                      T.ChaosInjector)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        T.journal_from_args(types.SimpleNamespace(durability=True))
    journal = T.journal_from_args(types.SimpleNamespace(durability=True,
                                                        checkpoint_dir=str(tmp_path)))
    assert journal.path == str(tmp_path / "server_round.journal")
    journal.close()
    window = T.ServerKillWindow.from_args(
        types.SimpleNamespace(chaos={"kill_server": {"round": 2}}))
    assert (window.round, window.after_uploads) == (2, 1)
    for cls in (T.AgentKillWindow, T.NodeDrain):
        with pytest.raises(NotImplementedError, match=r"A13"):
            cls("n1")
