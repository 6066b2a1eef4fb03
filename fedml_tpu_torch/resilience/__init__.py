"""Fault tolerance — counterpart of ``fedml_tpu/resilience``.

- :mod:`policy` — retry with deterministic jitter and the per-run
  :class:`ResilienceConfig`;
- :mod:`dedup` — receiver-side :class:`MessageDeduper`, so a resend is
  applied once;
- :mod:`liveness` — :class:`PeerLiveness`, last-seen tracking with
  eviction;
- :mod:`quorum` — :class:`RoundDeadline` and :func:`quorum_size`;
- :mod:`chaos` — :class:`ChaosInjector`, the seeded fault injector at the
  comm boundary (drop, delay, duplicate, kill or partition ranks for a
  round window, corrupt a rank's model), and :class:`ServerKillWindow`
  (SIGKILL the server mid-round);
- :mod:`durability` — the write-ahead round journal (:class:`RoundJournal`)
  whose replay lets a killed server re-enter the interrupted round with
  every upload it had received.

The scheduler tier's chaos (``AgentKillWindow``, ``NodeDrain``) raises,
naming ROADMAP A13. Counters land in the ``resilience/*`` namespace of the
port's registry.
"""
from fedml_tpu_torch.resilience.chaos import (
    AgentKillWindow,
    ChaosInjector,
    CorruptUpdateWindow,
    NaNWindow,
    NodeDrain,
    ServerKillWindow,
    chaos_from_args,
    corrupt_model_payload,
    run_chaos_scenario,
)
from fedml_tpu_torch.resilience.dedup import MessageDeduper
from fedml_tpu_torch.resilience.durability import (
    RoundJournal,
    SalvagedRound,
    journal_from_args,
    salvage_round,
)
from fedml_tpu_torch.resilience.liveness import PeerLiveness
from fedml_tpu_torch.resilience.policy import (
    ResilienceConfig,
    RetryPolicy,
    transient_exceptions,
)
from fedml_tpu_torch.resilience.quorum import (
    RoundDeadline,
    adaptive_deadline_s,
    quorum_size,
)

__all__ = [
    "AgentKillWindow",
    "ChaosInjector",
    "CorruptUpdateWindow",
    "MessageDeduper",
    "NaNWindow",
    "NodeDrain",
    "PeerLiveness",
    "ResilienceConfig",
    "RetryPolicy",
    "RoundDeadline",
    "RoundJournal",
    "SalvagedRound",
    "ServerKillWindow",
    "adaptive_deadline_s",
    "chaos_from_args",
    "corrupt_model_payload",
    "journal_from_args",
    "quorum_size",
    "run_chaos_scenario",
    "salvage_round",
    "transient_exceptions",
]
