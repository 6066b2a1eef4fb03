"""Fault tolerance — counterpart of ``fedml_tpu/resilience``: the parts the
cross-silo comm and server managers use. Retry with deterministic jitter
(:mod:`policy`), receiver-side dedup (:mod:`dedup`), peer liveness
(:mod:`liveness`) and round deadlines with quorum (:mod:`quorum`).

The chaos injector, the server-kill window and the durability journal are
the reference's too, but come with a later part of the port (ROADMAP
A10.3): the functions below return None while no argument asks for them
and raise when one does.
"""
from typing import Any, Optional

from fedml_tpu_torch.resilience.dedup import MessageDeduper
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


def chaos_from_args(args: Any) -> None:
    """The reference's chaos injector for ``args.chaos``: refused."""
    if getattr(args, "chaos", None):
        raise NotImplementedError(
            "chaos: fault injection comes with the durability journal "
            "(ROADMAP A10.3); the port has not ported it yet")
    return None


def journal_from_args(args: Any) -> None:
    """The reference's write-ahead round journal (``durability: true``):
    refused."""
    if getattr(args, "durability", False):
        raise NotImplementedError(
            "durability: the write-ahead round journal comes with ROADMAP "
            "A10.3; the port has not ported it yet")
    return None


class ServerKillWindow:
    """The reference's seeded server-kill window (``chaos: kill_server``)."""

    @staticmethod
    def from_args(args: Any) -> Optional["ServerKillWindow"]:
        chaos = getattr(args, "chaos", None)
        if isinstance(chaos, dict) and "kill_server" in chaos:
            raise NotImplementedError(
                "chaos kill_server comes with the durability journal "
                "(ROADMAP A10.3); the port has not ported it yet")
        return None


__all__ = [
    "MessageDeduper",
    "PeerLiveness",
    "ResilienceConfig",
    "RetryPolicy",
    "RoundDeadline",
    "ServerKillWindow",
    "adaptive_deadline_s",
    "chaos_from_args",
    "journal_from_args",
    "quorum_size",
    "transient_exceptions",
]
