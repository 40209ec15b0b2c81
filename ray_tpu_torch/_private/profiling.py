"""Profiling: device traces through torch.profiler, and the task timeline.

The port's counterpart of ray_tpu/_private/profiling.py: ``start_gpu_profile``,
``stop_gpu_profile`` and ``gpu_profile`` take the places of
``start_tpu_profile``, ``stop_tpu_profile`` and ``tpu_profile``
(jax.profiler there; reference: the runtime-env GPU profiler plugins,
python/ray/_private/runtime_env/nsight.py). A trace is written to
``logdir`` as a Chrome trace (open in chrome://tracing or Perfetto).
``timeline()`` reads the task events of the state API, which come with the
cluster runtime.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch import default_device
from ray_tpu_torch._private.worker import waits_for_cluster_mode


def timeline(filename: Optional[str] = None) -> Optional[List[Dict[str, Any]]]:
    """Chrome-trace events of task execution (reference: ray.timeline)."""
    raise waits_for_cluster_mode("timeline(), which reads the state API's task events,")


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
