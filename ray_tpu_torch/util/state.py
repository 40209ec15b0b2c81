"""State API — observability over cluster entities (copy of
ray_tpu/util/state.py).

Reference: python/ray/util/state/ (`StateApiClient` api.py:114,
`list_actors` :793, `list_tasks` :1020), backed by the GCS. Same shape
here: list/get functions returning plain dicts from the control plane.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod


def _gcs():
    return worker_mod._require_connected().core.gcs


def list_nodes() -> List[Dict[str, Any]]:
    """Reference: util/state list_nodes."""
    return worker_mod._require_connected().core.nodes()


def list_actors(filters: Optional[List] = None) -> List[Dict[str, Any]]:
    """Reference: util/state/api.py:793."""
    actors = _gcs().call_retrying("ListActors")
    out = [a for a in actors if a is not None]
    for f in filters or []:
        key, op, val = f
        if op == "=":
            out = [a for a in out if a.get(key) == val]
        elif op == "!=":
            out = [a for a in out if a.get(key) != val]
    return out


def get_actor(actor_id: str) -> Optional[Dict[str, Any]]:
    return _gcs().call_retrying("GetActorInfo", actor_id=actor_id)


def list_placement_groups() -> List[Dict[str, Any]]:
    return _gcs().call_retrying("ListPlacementGroups")


def list_jobs() -> List[Dict[str, Any]]:
    return _gcs().call_retrying("ListJobs")


def list_tasks(job_id: Optional[str] = None, limit: int = 1000) -> List[Dict[str, Any]]:
    """Recent task lifecycle events (reference: util/state/api.py:1020
    list_tasks over GcsTaskManager)."""
    return _gcs().call_retrying("ListTaskEvents", job_id=job_id, limit=limit)


def task_summary() -> Dict[str, int]:
    """Task counts by state (SUBMITTED minus FINISHED/FAILED ≈ running)."""
    counts: Dict[str, int] = {}
    for e in list_tasks(limit=20000):
        counts[e["state"]] = counts.get(e["state"], 0) + 1
    return counts


def list_events(etype: Optional[str] = None, job_id: Optional[str] = None,
                limit: int = 1000) -> List[Dict[str, Any]]:
    """Cluster event-bus history (observability/events.py): typed events
    (task state transitions, object put/get, actor restarts, collective
    ops, spans) aggregated at the GCS. Also at GET /api/v0/events."""
    return _gcs().call_retrying("ListClusterEvents", etype=etype,
                                job_id=job_id, limit=limit)


def get_trace(job_id: str) -> Dict[str, Any]:
    """A job's span tree from the distributed-tracing subsystem:
    ``{"job_id", "spans": [...], "roots": [...], "children": {...}}``.
    Same payload as GET /api/v0/traces/<job_id> on the dashboard head;
    export with ``ray_tpu_torch.observability.export_trace``."""
    return _gcs().call_retrying("GetTrace", job_id=job_id)


def actor_timeline(actor_id: str) -> Dict[str, Any]:
    """One actor's bring-up timeline from the control-plane lifecycle
    marks (``RAY_TPU_TIMELINE=1``): reconciled-clock phase marks
    (submit → registered → scheduled → lease_granted → worker_started
    → init_done → alive → first_ping) plus the per-transition
    durations. ``{"actor_id", "marks": [...], "transitions": [...]}``."""
    return _gcs().call_retrying("ActorTimeline", actor_id=actor_id)


def lifecycle_summary(job_id: Optional[str] = None,
                      wall_s: Optional[float] = None,
                      etype: str = "actor_lifecycle") -> Dict[str, Any]:
    """Critical-path breakdown across every timed entity of a job:
    per-phase p50/p99/mean plus a wall-clock attribution that sums to
    the measured wall (``wall_s``) by construction — the scale_bench
    many_actors per-phase row comes straight from this. ``etype`` may
    be ``"task_lifecycle"`` for the sampled task path."""
    return _gcs().call_retrying("LifecycleSummary", job_id=job_id,
                                wall_s=wall_s, etype=etype)


def list_node_stats() -> List[Dict[str, Any]]:
    """Latest per-node reporter samples (dashboard agents' reporter
    loops): cpu/mem, worker and lease counts, object-store fill."""
    return _gcs().call_retrying("ListNodeStats")


def metrics_endpoint() -> str:
    """Prometheus scrape address, e.g. "127.0.0.1:9201" (reference: the
    dashboard agent's metrics exporter)."""
    ep = _gcs().call_retrying("GetMetricsEndpoint")
    return f"{ep['host']}:{ep['port']}"


def get_logs(after_seq: int = 0, limit: int = 1000) -> Dict[str, Any]:
    """Buffered worker log lines: (seq, node_id, worker_id, line)."""
    return _gcs().call_retrying("GetLogs", after_seq=after_seq, limit=limit)


def cluster_summary() -> Dict[str, Any]:
    """Aggregate view (reference: `ray status` output / state summary)."""
    core = worker_mod._require_connected().core
    return {
        "nodes": core.nodes(),
        "total_resources": core.cluster_resources(),
        "available_resources": core.available_resources(),
        "actors": len(list_actors()),
        "placement_groups": len(list_placement_groups()),
        "tasks": task_summary(),
    }
