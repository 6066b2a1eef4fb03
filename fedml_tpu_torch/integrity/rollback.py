"""Ring 3 — the post-aggregate acceptance guard and the rollback budget;
counterpart of ``fedml_tpu/integrity/rollback.py``.

After every aggregate the guard checks that the new global parameters are
finite (one reduction on their device, one scalar read) and, on eval
rounds, that the eval loss has not spiked past ``loss_mult ×`` the EWMA of
accepted rounds. A rejected round is the caller's to unwind; past
``max_rollbacks`` consecutive rollbacks :meth:`record_rollback` raises
:class:`RollbackBudgetExceeded`, which every engine turns into a loud
abort.
"""
from __future__ import annotations

import logging
import math
from typing import Optional

import torch

from fedml_tpu_torch.telemetry import get_registry
from fedml_tpu_torch.utils.tree import Tree, tree_leaves

logger = logging.getLogger(__name__)

__all__ = ["AcceptanceGuard", "RollbackBudgetExceeded", "params_finite"]


class RollbackBudgetExceeded(RuntimeError):
    """More consecutive rollbacks than ``max_rollbacks``: the poisoning is
    persistent and containment has failed."""


def params_finite(params: Tree) -> bool:
    """All float leaves finite: one reduction, one scalar read."""
    flags = [torch.isfinite(x).all() for x in tree_leaves(params)
             if x.is_floating_point()]
    return bool(torch.stack(flags).all()) if flags else True


class AcceptanceGuard:
    """Accept-or-rollback decision per aggregated round."""

    def __init__(self, loss_mult: float = 2.0, min_history: int = 1,
                 max_rollbacks: int = 2, ewma_alpha: float = 0.3):
        self.loss_mult = float(loss_mult)
        self.min_history = max(1, int(min_history))
        self.max_rollbacks = int(max_rollbacks)
        self.ewma_alpha = float(ewma_alpha)
        self._loss_ewma: Optional[float] = None
        self._accepted = 0
        # CONSECUTIVE rollbacks: an accepted round re-arms the budget
        self.rollbacks = 0
        self.total_rollbacks = 0

    def check(self, params: Optional[Tree], eval_loss: Optional[float] = None
              ) -> Optional[str]:
        """None = accept; else the rejection reason. ``params=None`` skips
        the finiteness reduction (a second gate on params already checked)."""
        if params is not None and not params_finite(params):
            return "aggregated params contain non-finite values"
        if eval_loss is not None:
            try:
                loss = float(eval_loss)
            except (TypeError, ValueError):
                return None
            if not math.isfinite(loss):
                return f"eval loss is non-finite ({eval_loss})"
            if (self._accepted >= self.min_history and self._loss_ewma is not None
                    and self._loss_ewma > 0 and loss > self.loss_mult * self._loss_ewma):
                return (f"eval loss {loss:.4g} spiked past {self.loss_mult:g}x the "
                        f"accepted-history EWMA {self._loss_ewma:.4g}")
        return None

    def accept(self, eval_loss: Optional[float] = None) -> None:
        """The round passed: fold its loss into the history, re-arm the
        consecutive-rollback budget."""
        self._accepted += 1
        self.rollbacks = 0
        if eval_loss is None:
            return
        try:
            loss = float(eval_loss)
        except (TypeError, ValueError):
            return
        if math.isfinite(loss):
            a = self.ewma_alpha
            self._loss_ewma = (loss if self._loss_ewma is None
                               else a * loss + (1 - a) * self._loss_ewma)

    def record_rollback(self, round_idx: int, reason: str) -> None:
        """Book one rollback; raises past the consecutive budget."""
        self.rollbacks += 1
        self.total_rollbacks += 1
        get_registry().counter("integrity/rollbacks").inc()
        logger.error("round %d REJECTED (%s) — rolling back to the last accepted "
                     "state (rollback %d/%d)", round_idx, reason, self.rollbacks,
                     self.max_rollbacks)
        if self.rollbacks > self.max_rollbacks:
            get_registry().counter("integrity/rollback_aborts").inc()
            raise RollbackBudgetExceeded(
                f"round {round_idx} rolled back {self.rollbacks} consecutive "
                f"time(s) (> max_rollbacks={self.max_rollbacks}): the corruption "
                "is persistent — aborting instead of oscillating")
