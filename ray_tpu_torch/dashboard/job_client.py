"""JobSubmissionClient — HTTP client for the job-submission API (copy of
ray_tpu/dashboard/job_client.py).

Reference surface: python/ray/dashboard/modules/job/sdk.py:37
(`JobSubmissionClient`). stdlib urllib, no dependencies.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional


class JobSubmissionClient:
    def __init__(self, address: str):
        """address: the dashboard URL, e.g. "http://127.0.0.1:8265"."""
        self.address = address.rstrip("/")
        if not self.address.startswith("http"):
            self.address = "http://" + self.address

    def _request(self, method: str, path: str,
                 payload: Optional[dict] = None) -> Any:
        data = json.dumps(payload).encode() if payload is not None else None
        req = urllib.request.Request(
            self.address + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            body = e.read().decode(errors="replace")
            try:
                msg = json.loads(body).get("error", body)
            except Exception:  # noqa: BLE001
                msg = body
            raise RuntimeError(f"{method} {path}: {msg}") from None

    # -- API (reference: sdk.py) --------------------------------------
    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[dict] = None) -> str:
        reply = self._request("POST", "/api/jobs/", {
            "entrypoint": entrypoint,
            "submission_id": submission_id,
            "runtime_env": runtime_env,
            "metadata": metadata,
        })
        return reply["submission_id"]

    def list_jobs(self) -> List[Dict]:
        return self._request("GET", "/api/jobs/")

    def get_job_info(self, submission_id: str) -> Dict:
        return self._request("GET", f"/api/jobs/{submission_id}")

    def get_job_status(self, submission_id: str) -> str:
        return self.get_job_info(submission_id)["status"]

    def get_job_logs(self, submission_id: str) -> str:
        return self._request(
            "GET", f"/api/jobs/{submission_id}/logs")["logs"]

    def stop_job(self, submission_id: str) -> bool:
        return self._request(
            "POST", f"/api/jobs/{submission_id}/stop")["stopped"]

    def tail_job_logs(self, submission_id: str, poll_s: float = 0.5):
        """Generator of new log text until the job reaches a terminal
        state (reference: sdk.py tail_job_logs, sync flavor)."""
        seen = 0
        while True:
            logs = self.get_job_logs(submission_id)
            if len(logs) > seen:
                yield logs[seen:]
                seen = len(logs)
            if self.get_job_status(submission_id) in (
                    "SUCCEEDED", "FAILED", "STOPPED"):
                rest = self.get_job_logs(submission_id)
                if len(rest) > seen:
                    yield rest[seen:]
                return
            time.sleep(poll_s)
