"""Contribution assessment — Shapley-style data valuation, counterpart of
``fedml_tpu/core/contribution`` (GTG-Shapley, MR-Shapley, leave-one-out)."""
from fedml_tpu_torch.core.contribution.contribution_assessor_manager import (
    ContributionAssessorManager,
)
from fedml_tpu_torch.core.contribution.gtg_shapley import gtg_shapley, leave_one_out, mr_shapley

__all__ = ["ContributionAssessorManager", "gtg_shapley", "leave_one_out", "mr_shapley"]
