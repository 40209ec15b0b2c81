"""Per-stage observability for the Podracer pipelines (copy of
ray_tpu/rllib/podracer/obs.py).

Every hop of the trajectory path gets a named span (recorded through
``observability.tracing`` when tracing is enabled/sampled) plus an
always-on wall-clock accumulator, so both the trace view and the bench
rows can attribute time to env stepping vs transport vs learning.

Riding the shared stack rather than a private one:

- ``track`` feeds the ``ray_tpu_podracer_stage_seconds`` histogram on
  the standard ``util/metrics.py`` registry — stage latencies land on
  the same Prometheus scrape as task/collective metrics and inside
  flight-recorder dump shards (``dump.py`` snapshots the registry).
- ``snapshot`` drops one ``podracer_stage`` event on the event bus, so
  the per-stage totals are in the GCS event history and in every debug
  dump of the process, not only in the bench row that asked.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

from ray_tpu_torch.observability import events, tracing

STAGE_ENV_STEP = "podracer.env_step"
STAGE_ENQUEUE = "podracer.enqueue"
STAGE_DEQUEUE = "podracer.dequeue"
STAGE_UPDATE = "podracer.update"
STAGE_WEIGHT_SYNC = "podracer.weight_sync"


def _stage_histogram():
    from ray_tpu_torch.util.metrics import get_histogram

    return get_histogram(
        "ray_tpu_podracer_stage_seconds",
        description="Podracer pipeline per-stage wall clock",
        boundaries=(0.0005, 0.002, 0.01, 0.05, 0.2, 1.0, 5.0, 30.0),
        tag_keys=("stage",),
    )


class StageTimes:
    """Cheap per-stage wall-clock accounting; `track` also emits a
    tracing span and a shared-registry histogram sample so traces,
    Prometheus and dump shards all show the same stage names."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def track(self, stage: str, **attrs):
        t0 = time.perf_counter()
        with tracing.span(stage, kind="podracer", attrs=attrs or None):
            yield
        dt = time.perf_counter() - t0
        self.seconds[stage] = self.seconds.get(stage, 0.0) + dt
        self.counts[stage] = self.counts.get(stage, 0) + 1
        try:
            _stage_histogram().observe(dt, tags={"stage": stage})
        except Exception:  # noqa: BLE001 — metrics must not fail the stage
            pass

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        doc = {
            stage: {"s": round(self.seconds[stage], 6),
                    "n": self.counts.get(stage, 0)}
            for stage in self.seconds
        }
        if doc:
            try:
                events.record_event("podracer_stage", stages=doc)
            except Exception:  # noqa: BLE001 — bus must not fail snapshot
                pass
        return doc
