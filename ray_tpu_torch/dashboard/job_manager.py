"""Job manager — driver-script lifecycle behind the job-submission API
(copy of ray_tpu/dashboard/job_manager.py).

Reference: python/ray/dashboard/modules/job/job_manager.py. A submitted
job is a subprocess running the entrypoint with RAY_TPU_ADDRESS exported
(the script's ``ray_tpu_torch.init()`` with no address connects to the
cluster: ``_private/worker.py::ADDRESS_ENV``); stdout/stderr go
to a per-job log file; a monitor thread tracks PENDING → RUNNING →
SUCCEEDED/FAILED/STOPPED. Submission records persist in the GCS KV
(namespace "job_submissions") so `list_jobs` survives a dashboard
restart — the reference stores them in the GCS internal KV the same way.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import tempfile
import threading
import time
import uuid
from typing import Dict, List, Optional, Tuple

JOB_KV_NAMESPACE = "job_submissions"


class JobManager:
    def __init__(self, gcs_addr: Tuple[str, int],
                 log_dir: Optional[str] = None):
        from ray_tpu_torch._private.rpc import RpcClient

        self.gcs_addr = tuple(gcs_addr)
        self.gcs = RpcClient(*self.gcs_addr)
        self.log_dir = log_dir or tempfile.mkdtemp(prefix="ray_tpu_torch_jobs_")
        self._procs: Dict[str, subprocess.Popen] = {}
        self._stopping: set = set()  # sids being stopped (monitor race)
        self._lock = threading.Lock()

    # -- KV-backed records --------------------------------------------
    def _put_record(self, rec: dict) -> None:
        self.gcs.call(
            "KVPut", ns=JOB_KV_NAMESPACE,
            key=rec["submission_id"],
            value=json.dumps(rec).encode(), overwrite=True, timeout=10)

    def _get_record(self, submission_id: str) -> Optional[dict]:
        v = self.gcs.call("KVGet", ns=JOB_KV_NAMESPACE,
                          key=submission_id, timeout=10)
        return json.loads(v) if v else None

    def list_jobs(self) -> List[dict]:
        keys = self.gcs.call("KVKeys", ns=JOB_KV_NAMESPACE,
                             prefix="", timeout=10) or []
        out = []
        for k in keys:
            rec = self._get_record(k if isinstance(k, str) else k.decode())
            if rec:
                out.append(rec)
        return sorted(out, key=lambda r: r.get("start_time") or 0)

    # -- lifecycle -----------------------------------------------------
    def submit_job(
        self,
        entrypoint: str,
        submission_id: Optional[str] = None,
        runtime_env: Optional[dict] = None,
        metadata: Optional[dict] = None,
    ) -> str:
        submission_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        if self._get_record(submission_id):
            raise ValueError(f"job {submission_id!r} already exists")
        runtime_env = runtime_env or {}
        log_path = os.path.join(self.log_dir, f"{submission_id}.log")
        env = dict(os.environ)
        env["RAY_TPU_ADDRESS"] = f"{self.gcs_addr[0]}:{self.gcs_addr[1]}"
        env.update({str(k): str(v)
                    for k, v in (runtime_env.get("env_vars") or {}).items()})
        cwd = runtime_env.get("working_dir") or None
        rec = {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": "PENDING",
            "start_time": time.time(),
            "end_time": None,
            "metadata": metadata or {},
            "log_path": log_path,
            "message": "",
        }
        self._put_record(rec)
        try:
            logf = open(log_path, "ab")
            proc = subprocess.Popen(
                ["bash", "-c", entrypoint], env=env, cwd=cwd,
                stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True,  # own process group for stop_job
            )
        except Exception as e:  # noqa: BLE001
            rec.update(status="FAILED", end_time=time.time(),
                       message=f"failed to start: {e}")
            self._put_record(rec)
            return submission_id
        with self._lock:
            self._procs[submission_id] = proc
        rec["status"] = "RUNNING"
        rec["pid"] = proc.pid  # stop_job fallback after a manager restart
        self._put_record(rec)
        threading.Thread(target=self._monitor, args=(submission_id, proc),
                         daemon=True).start()
        return submission_id

    def _monitor(self, submission_id: str, proc: subprocess.Popen) -> None:
        rc = proc.wait()
        with self._lock:
            # both waits return at process death; the _stopping marker is
            # set BEFORE the signal, so a user-stopped job is never
            # overwritten as FAILED(exit -15) by this thread
            if submission_id in self._stopping:
                return
        rec = self._get_record(submission_id) or {}
        if rec.get("status") == "STOPPED":
            return  # stop_job already wrote the terminal record
        rec.update(
            status="SUCCEEDED" if rc == 0 else "FAILED",
            end_time=time.time(),
            message="" if rc == 0 else f"exit code {rc}",
        )
        self._put_record(rec)
        with self._lock:
            self._procs.pop(submission_id, None)

    def get_job_status(self, submission_id: str) -> Optional[str]:
        rec = self._get_record(submission_id)
        return rec["status"] if rec else None

    def get_job_info(self, submission_id: str) -> Optional[dict]:
        return self._get_record(submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        rec = self._get_record(submission_id)
        if not rec:
            raise ValueError(f"no job {submission_id!r}")
        try:
            with open(rec["log_path"], "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop_job(self, submission_id: str) -> bool:
        with self._lock:
            proc = self._procs.pop(submission_id, None)
            self._stopping.add(submission_id)
        rec = self._get_record(submission_id)
        pid = proc.pid if proc is not None else (rec or {}).get("pid")
        signaled = False
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
            except Exception:  # noqa: BLE001
                proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
                except Exception:  # noqa: BLE001
                    proc.kill()
            signaled = True
        elif proc is None and pid:
            # manager restarted: the record's pid is the only handle to
            # the (session-leading) orphan — signal its process group
            try:
                os.killpg(pid, signal.SIGTERM)
                signaled = True
            except ProcessLookupError:
                pass  # already gone
            except Exception:  # noqa: BLE001
                pass
        if rec and rec.get("status") in ("PENDING", "RUNNING"):
            # mark STOPPED only once the process was signaled or is gone —
            # never report a job stopped while its entrypoint still runs
            gone = True
            if pid:
                try:
                    os.kill(pid, 0)
                    gone = False
                except ProcessLookupError:
                    gone = True
            if signaled or gone:
                rec.update(status="STOPPED", end_time=time.time())
                self._put_record(rec)
        return signaled

    def shutdown(self) -> None:
        with self._lock:
            ids = list(self._procs)
        for sid in ids:
            self.stop_job(sid)
