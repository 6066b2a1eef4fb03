"""DP budget accountant — RDP composition for the Gaussian mechanism; a copy
of ``fedml_tpu/core/dp/budget_accountant.py``. The implementation follows the
standard Rényi-DP recipe (Mironov '17): one Gaussian release with noise
multiplier σ (= sigma / sensitivity) costs RDP(α) = α / (2σ²); T compositions sum; conversion to
(ε, δ)-DP takes the minimum over α of

    ε(α) = T·α/(2σ²) + log(1/δ)/(α − 1).

The accountant also supports a hard ε budget: :meth:`check_budget` raises
once the spend would exceed it, so a run stops *before* over-spending.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Sequence

DEFAULT_ORDERS = tuple([1 + x / 10.0 for x in range(1, 100)]
                       + list(range(11, 64)) + [128, 256, 512])


class RDPAccountant:
    def __init__(self, noise_multiplier: float,
                 orders: Sequence[float] = DEFAULT_ORDERS):
        if noise_multiplier <= 0:
            raise ValueError("noise_multiplier must be positive")
        self.noise_multiplier = float(noise_multiplier)
        self.orders = tuple(orders)
        self.steps = 0

    def step(self, n: int = 1) -> None:
        self.steps += int(n)

    def get_epsilon(self, delta: float) -> float:
        """(ε, δ)-DP spend after the recorded steps."""
        if self.steps == 0:
            return 0.0
        sigma2 = self.noise_multiplier ** 2
        best = math.inf
        for a in self.orders:
            if a <= 1:
                continue
            rdp = self.steps * a / (2.0 * sigma2)
            eps = rdp + math.log(1.0 / delta) / (a - 1.0)
            best = min(best, eps)
        return best


class BudgetAccountant:
    """Run-level accountant bound to the DP config (epsilon/delta are the
    *per-release* calibration; ``max_epsilon`` is the total budget)."""

    def __init__(self, args: Any):
        from fedml_tpu_torch.core.dp.mechanisms import gaussian_sigma

        self.delta = float(getattr(args, "delta", 1e-5))
        eps = float(getattr(args, "epsilon", 1.0))
        sens = float(getattr(args, "sensitivity", 1.0))
        # noise multiplier = sigma / sensitivity for the configured mechanism
        self.noise_multiplier = gaussian_sigma(eps, self.delta, sens) / sens
        self.rdp = RDPAccountant(self.noise_multiplier)
        self.max_epsilon: Optional[float] = None
        if getattr(args, "max_epsilon", None) is not None:
            self.max_epsilon = float(args.max_epsilon)

    def record_release(self, n: int = 1) -> None:
        self.rdp.step(n)

    def epsilon_spent(self) -> float:
        return self.rdp.get_epsilon(self.delta)

    def check_budget(self, pending: int = 1) -> None:
        """Raise BudgetExceeded if the next ``pending`` releases would break
        the budget (a batched release — e.g. mesh LDP keys for n clients —
        must be probed as n compositions, not 1)."""
        if self.max_epsilon is None:
            return
        probe = RDPAccountant(self.noise_multiplier)
        probe.steps = self.rdp.steps + max(1, int(pending))
        if probe.get_epsilon(self.delta) > self.max_epsilon:
            raise BudgetExceededError(
                f"next DP release would exceed max_epsilon={self.max_epsilon} "
                f"(spent ≈ {self.epsilon_spent():.3f} after {self.rdp.steps} releases)"
            )


class BudgetExceededError(RuntimeError):
    pass
