"""Profiling: device traces through torch.profiler, and the task timeline.

The port's counterpart of ray_tpu/_private/profiling.py: ``start_gpu_profile``,
``stop_gpu_profile`` and ``gpu_profile`` take the places of
``start_tpu_profile``, ``stop_tpu_profile`` and ``tpu_profile``
(jax.profiler there; reference: the runtime-env GPU profiler plugins,
python/ray/_private/runtime_env/nsight.py). A trace is written to
``logdir`` as a Chrome trace (open in chrome://tracing or Perfetto).
``timeline()`` (a copy of JAX's) reads the task events of the state API
from the cluster's GCS.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch import default_device


def timeline(filename: Optional[str] = None) -> Optional[List[Dict[str, Any]]]:
    """Chrome-trace events of task execution (open in chrome://tracing
    or Perfetto). Spans: queued (SUBMITTED→RUNNING) and execution
    (RUNNING→FINISHED/FAILED); tasks missing a RUNNING event fall back
    to one SUBMITTED→end span.

    Reference surface: ray.timeline(_private/profiling.py).
    """
    from ray_tpu_torch.util.state import list_tasks

    by_task: Dict[str, Dict[str, dict]] = {}
    for ev in list_tasks(limit=20000):
        by_task.setdefault(ev["task_id"], {})[ev["state"]] = ev
    events: List[Dict[str, Any]] = []
    for tid, states in by_task.items():
        sub = states.get("SUBMITTED")
        run = states.get("RUNNING")
        end = states.get("FINISHED") or states.get("FAILED")
        name = (end or run or sub or {}).get("name", "?")
        failed = "FAILED" in states
        if sub and run:
            events.append({
                "name": f"queued:{name}", "cat": "queue", "ph": "X",
                "ts": sub["ts"] * 1e6,
                "dur": max(0.0, (run["ts"] - sub["ts"]) * 1e6),
                "pid": sub.get("job_id", "job"),
                "tid": run.get("worker", "worker"),
                "args": {"task_id": tid},
            })
        start = run or sub
        if start and end:
            events.append({
                "name": name, "cat": "task", "ph": "X",
                "ts": start["ts"] * 1e6,
                "dur": max(0.0, (end["ts"] - start["ts"]) * 1e6),
                "pid": start.get("job_id", "job"),
                "tid": (run or end).get("worker", "worker"),
                "args": {"task_id": tid, "state": end["state"],
                         "failed": failed},
            })
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
        return None
    return events


# (profiler, logdir) of the trace in flight
_active: Optional[tuple] = None


def start_gpu_profile(logdir: str, device=None) -> None:
    """Start a torch.profiler trace of the host and the card. ``device``:
    None means the card (and raises without one); ``"cpu"`` traces the
    host alone."""
    global _active
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if default_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    _active = (prof, logdir)


def stop_gpu_profile() -> Optional[str]:
    """Stop the trace in flight and write it to its ``logdir``; returns the
    file's path (None when no trace was in flight)."""
    global _active
    if _active is None:
        return None
    (prof, logdir), _active = _active, None
    prof.stop()
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


class gpu_profile:
    """Context manager: ``with ray_tpu_torch.gpu_profile("/tmp/trace"): step()``;
    ``.path`` is the trace's file after the block."""

    def __init__(self, logdir: str, device=None):
        self.logdir = logdir
        self.device = device
        self.path: Optional[str] = None

    def __enter__(self):
        start_gpu_profile(self.logdir, self.device)
        return self

    def __exit__(self, *exc):
        self.path = stop_gpu_profile()
        return False
