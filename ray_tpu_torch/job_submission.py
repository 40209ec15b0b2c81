"""ray_tpu_torch.job_submission — reference-parity alias for the job API
(copy of ray_tpu/job_submission.py; reference: `ray.job_submission` re-exporting the dashboard SDK,
python/ray/job_submission/__init__.py)."""

from ray_tpu_torch.dashboard.job_client import JobSubmissionClient


class JobStatus:
    """String states (reference: job_submission JobStatus enum)."""

    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


__all__ = ["JobStatus", "JobSubmissionClient"]
