"""The scheduler tier — counterpart of ``fedml_tpu/scheduler``. Only the
supervision policy is ported (:mod:`supervision`, for the kill-and-respawn
runner); the agents, the master and the job plane come with ROADMAP A13."""
from fedml_tpu_torch.scheduler.supervision import RestartPolicy, RestartTracker, describe_rc

__all__ = ["RestartPolicy", "RestartTracker", "describe_rc"]
