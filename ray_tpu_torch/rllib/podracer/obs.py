"""Per-stage wall-clock accounting for the Podracer pipelines (PyTorch
port of ray_tpu/rllib/podracer/obs.py).

``StageTimes.track`` adds each stage's wall-clock time and count, and
``snapshot`` reports them, as in the JAX package. There each stage is
also a tracing span, a sample of the ``ray_tpu_podracer_stage_seconds``
histogram and a ``podracer_stage`` event on the event bus; those wait
for the port of the observability layer (ROADMAP.md Queue A item 10b).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

STAGE_UPDATE = "podracer.update"  # Sebulba's other stages wait for its port


class StageTimes:
    """Cheap per-stage wall-clock accounting."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def track(self, stage: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.seconds[stage] = self.seconds.get(stage, 0.0) + dt
        self.counts[stage] = self.counts.get(stage, 0) + 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {stage: {"s": round(self.seconds[stage], 6), "n": self.counts.get(stage, 0)}
                for stage in self.seconds}
