"""ray_tpu_torch.dashboard — cluster dashboard + job submission server
(copy of ray_tpu/dashboard).

Reference: python/ray/dashboard (DashboardHead head.py:49, job module).
HTTP API over GCS state plus a subprocess-based JobManager;
JobSubmissionClient mirrors ray.job_submission.JobSubmissionClient.
"""

from ray_tpu_torch.dashboard.head import DashboardHead
from ray_tpu_torch.dashboard.job_client import JobSubmissionClient
from ray_tpu_torch.dashboard.job_manager import JobManager

__all__ = ["DashboardHead", "JobManager", "JobSubmissionClient"]
