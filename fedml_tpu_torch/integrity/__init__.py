"""Update-integrity containment — counterpart of ``fedml_tpu/integrity``:
the layer that survives a *bad update* (NaN/Inf blocks, a diverging loss,
a poisoned delta), in three rings on the fused compressed aggregation path:

- :mod:`.screen` — ring 1, admission: every upload screened in the
  compressed domain (non-finite blocks and scales, norm overflow against
  the accepted-norm median, per-block robust z at round close); flagged
  uploads are dropped and counted, their senders quarantined;
- :mod:`.robust_agg` — ring 2, aggregation: the coordinate-wise trimmed
  mean or median of the stacked compressed deltas, instead of the weighted
  mean;
- :mod:`.rollback` — ring 3, acceptance: non-finite parameters or an
  eval-loss spike reject the round, which the engine rolls back to its
  round-open state and re-runs with a fresh cohort, within a budget.

:mod:`.quarantine` holds the list both outer rings feed. Everything is
counted under the reference's ``integrity/*`` names in the port's metrics
registry, and each screened upload, quarantine and rollback is an
``integrity_event`` record in ``health.jsonl`` with its flight-recorder
copy, which the doctor's integrity section reads.
"""
from __future__ import annotations

from typing import Any, Optional

from fedml_tpu_torch.integrity.quarantine import QuarantineList
from fedml_tpu_torch.integrity.robust_agg import (
    fused_robust_sum,
    parse_robust_spec,
    resolve_agg_robust,
)
from fedml_tpu_torch.integrity.rollback import AcceptanceGuard, RollbackBudgetExceeded
from fedml_tpu_torch.integrity.screen import UpdateScreen, screen_stats


class IntegrityConfig:
    """The integrity knobs, read once off the flat args namespace, with the
    reference's names and defaults. ``integrity: true`` arms rings 1 and 3;
    ``integrity_screen`` / ``integrity_rollback`` toggle each; ring 2 is
    selected by ``agg_robust`` (or a fused defense)."""

    def __init__(self, args: Any = None):
        def g(k, d):
            return getattr(args, k, d) if args is not None else d

        master = bool(g("integrity", False))
        self.screen_enabled = bool(g("integrity_screen", master))
        self.rollback_enabled = bool(g("integrity_rollback", master))
        # ring 1: norm overflow past mult × the accepted-norm median; a
        # per-block robust z past the threshold is an outlier
        self.norm_mult = float(g("integrity_norm_mult", 10.0))
        self.z_threshold = float(g("integrity_z_threshold", 8.0))
        self.quarantine_rounds = int(g("quarantine_rounds", 2))
        # ring 3: the eval-loss spike factor against the accepted EWMA, the
        # history it needs, and the rollback budget
        self.loss_mult = float(g("integrity_loss_mult", 2.0))
        self.loss_min_history = int(g("integrity_loss_min_history", 1))
        self.max_rollbacks = int(g("max_rollbacks", 2))

    @property
    def any_enabled(self) -> bool:
        return self.screen_enabled or self.rollback_enabled

    @classmethod
    def from_args(cls, args: Any) -> Optional["IntegrityConfig"]:
        cfg = cls(args)
        return cfg if cfg.any_enabled else None


__all__ = [
    "AcceptanceGuard",
    "IntegrityConfig",
    "QuarantineList",
    "RollbackBudgetExceeded",
    "UpdateScreen",
    "fused_robust_sum",
    "parse_robust_spec",
    "resolve_agg_robust",
    "screen_stats",
]
