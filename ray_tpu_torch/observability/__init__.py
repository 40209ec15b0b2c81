"""Cluster observability: structured event bus + distributed tracing (copy of
ray_tpu/observability/__init__.py).

Reference counterparts: the per-node dashboard agent's reporter/metrics
modules (python/ray/dashboard/agent.py:35), the GCS-side task-event
manager (GcsTaskManager — bounded event history behind the state API),
and OpenTelemetry-style span propagation through task specs.

Three layers:

- **Event bus** (`events.py`): every process keeps a bounded
  flight-recorder ring of typed events (task state transitions, object
  put/get sizes, actor restarts, collective op start/end, spans) and a
  flusher thread ships batches to the GCS-side aggregator.
- **Distributed tracing** (`tracing.py`): a span context
  (trace_id, parent_span_id) is injected into task specs and actor
  submits by the core worker and extracted in the executor, so
  parent→child spans cross process boundaries. Sampled and
  OFF BY DEFAULT — the disabled check is one thread-local read, so the
  sync-latency path pays near-zero.
- **Exporters** (`export.py`): Chrome-trace / Perfetto JSON of a job's
  span tree; Prometheus task-latency and queue-wait histograms ride the
  existing `util/metrics.py` push+scrape pipeline.

Quick start (driver)::

    from ray_tpu_torch import observability as obs
    obs.configure(enabled=True)           # or RAY_TPU_TRACE=1
    with obs.span("pipeline"):
        ray_tpu_torch.get(step.remote(...))     # worker spans parent here
    spans = rstate.get_trace(job_id)["spans"]
    obs.export_trace(job_id, "/tmp/trace.json")   # chrome://tracing
"""

from __future__ import annotations

from ray_tpu_torch.observability.dump import (
    counter_sample,
    dump_now,
    trigger_cluster_dump,
)
from ray_tpu_torch.observability.events import (
    local_events,
    record_event,
)
from ray_tpu_torch.observability.export import (
    export_trace,
    to_chrome_trace,
)
from ray_tpu_torch.observability.schema import EVENT_TYPES
from ray_tpu_torch.observability.timeline import (
    mark_actor,
    mark_task,
)
from ray_tpu_torch.observability.tracing import (
    TraceContext,
    configure,
    current_context,
    enabled,
    seed_sampler,
    span,
)

__all__ = [
    "TraceContext",
    "configure",
    "current_context",
    "enabled",
    "seed_sampler",
    "span",
    "record_event",
    "local_events",
    "to_chrome_trace",
    "export_trace",
    "EVENT_TYPES",
    "mark_actor",
    "mark_task",
    "counter_sample",
    "dump_now",
    "trigger_cluster_dump",
]
