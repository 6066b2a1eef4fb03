"""ContributionAssessorManager — per-round participant valuation,
counterpart of ``fedml_tpu/core/contribution/contribution_assessor_manager.py``.

The server calls :meth:`ContributionAssessorManager.run` after aggregation
with the round's client models; the utility of a coalition is the
validation metric of that coalition's count-weighted aggregate
(``FedMLAggOperator.agg``). The values accumulate across rounds into the
Context (``KEY_CLIENT_CONTRIBUTIONS``). The games are host numpy over the
utility; each utility is one evaluation on the engine's device.

Config (``train_args``)::

    enable_contribution: true
    contribution_method: gtg_shapley | mr_shapley | leave_one_out
    contribution_max_perms: 32       # GTG permutations above 5 clients
    contribution_trunc_eps: 0.001    # GTG guided truncation
    contribution_round_trunc: 0.01   # MR: skip rounds that moved the
                                     # utility by less than this
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Sequence, Tuple

from fedml_tpu_torch.core.alg_frame.params import Context
from fedml_tpu_torch.core.contribution.gtg_shapley import (
    gtg_shapley,
    leave_one_out,
    mr_shapley,
)
from fedml_tpu_torch.utils.tree import Tree

logger = logging.getLogger(__name__)


class ContributionAssessorManager:
    def __init__(self, args: Any):
        self.args = args
        self.enabled = bool(getattr(args, "enable_contribution", False))
        self.method = str(getattr(args, "contribution_method", "gtg_shapley")).lower()
        self.max_permutations = int(getattr(args, "contribution_max_perms", 32))
        self.eps = float(getattr(args, "contribution_trunc_eps", 1e-3))
        self.round_trunc = float(getattr(args, "contribution_round_trunc", 0.01))
        self.accumulated: Dict[int, float] = {}
        self.utility_calls = 0  # utilities evaluated by the last run()

    def is_enabled(self) -> bool:
        return self.enabled

    def run(self, client_ids: Sequence[int], w_locals: List[Tuple[int, Tree]],
            utility_of_params: Callable[[Tree], float], utility_empty: float,
            round_idx: int = 0) -> Dict[int, float]:
        """``w_locals``: the round's ``[(n_samples, params)]`` in
        ``client_ids`` order. Returns this round's value per client id."""
        from fedml_tpu_torch.ml.aggregator.agg_operator import FedMLAggOperator

        self.utility_calls = 0

        def utility(subset: Sequence[int]) -> float:
            if not len(subset):
                return utility_empty
            self.utility_calls += 1
            agg = FedMLAggOperator.agg(self.args, [w_locals[i] for i in subset])
            return float(utility_of_params(agg))

        n = len(w_locals)
        if self.method == "leave_one_out":
            phi = leave_one_out(n, utility)
        elif self.method in ("mr", "mr_shapley"):
            # a round that barely moved the utility gives ~0 to everyone:
            # skip the 2^n sweep (the reference's round truncation)
            v_full = utility(list(range(n)))
            if abs(v_full - utility_empty) < self.round_trunc:
                logger.info("round %d: utility moved %.4f < %.4f — MR-Shapley round "
                            "truncated", round_idx, abs(v_full - utility_empty),
                            self.round_trunc)
                phi = [0.0] * n
            else:
                phi = mr_shapley(n, utility, utility_empty)
        else:
            phi = gtg_shapley(
                n, utility, utility_empty, max_permutations=self.max_permutations,
                eps=self.eps, seed=int(getattr(self.args, "random_seed", 0)) + round_idx)
        values = {int(cid): float(phi[i]) for i, cid in enumerate(client_ids)}
        for cid, val in values.items():
            self.accumulated[cid] = self.accumulated.get(cid, 0.0) + val
        Context().add(Context.KEY_CLIENT_CONTRIBUTIONS, dict(self.accumulated))
        logger.info("round %d contributions: %s", round_idx, values)
        return values
