"""Crash-anywhere durability — counterpart of
``fedml_tpu/resilience/durability``: the write-ahead round journal and its
replay.

- :mod:`journal` — :class:`RoundJournal` (append-only, fsynced,
  CRC-framed, torn tails truncated), :func:`salvage_round`, and the
  :func:`journal_from_args` hook the engines share.
- :mod:`recover` — the supervised kill-and-respawn runner behind
  ``python -m fedml_tpu_torch.cli chaos --kill-server``: a cross-silo
  federation as OS processes over the broker, the server SIGKILLed mid-round
  and respawned with ``resume: true``, measured for MTTR, salvaged uploads
  and bit-identity against an uninterrupted run.

Wired into the synchronous cross-silo server (mid-round re-entry) and the
async server's FedBuff buffer, and into the aggregation tree's edge
aggregators (``hierarchy.EdgeAggregator.bind_journal``). Counters: ``resilience/journal_*`` and
``resilience/restarts`` in the port's registry; the append and replay
histograms: ``journal/upload_ms``, ``journal/upload_bytes`` and
``journal/replay_ms`` (the reference's taxonomy keeps histograms out of
``resilience/``).
"""
from fedml_tpu_torch.resilience.durability.journal import (
    RoundJournal,
    SalvagedRound,
    journal_from_args,
    salvage_round,
)
from fedml_tpu_torch.resilience.durability.recover import run_recover_scenario

__all__ = [
    "RoundJournal",
    "SalvagedRound",
    "journal_from_args",
    "run_recover_scenario",
    "salvage_round",
]
