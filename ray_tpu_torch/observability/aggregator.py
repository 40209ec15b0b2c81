"""Head-side aggregation of bus events (runs inside the GCS process) (copy of
ray_tpu/observability/aggregator.py).

Reference: GcsTaskManager — the GCS keeps a bounded, queryable history
of worker-pushed events rather than a full time-series store. Spans are
additionally indexed by job so ``GetTrace`` is O(job), not O(history).

Clock reconciliation: event batches arrive with a sender clock pair
``{"mono", "wall"}`` captured at flush time. The aggregator estimates
each sender's monotonic offset against its OWN clock as the *minimum*
over batches of ``recv_mono - batch_mono`` (the batch with the least
transit delay bounds the true offset tightest — NTP's minimum-filter
idea), then stamps every monotonic-bearing event with a reconciled
``gts`` on the GCS timebase. On one host the offsets are ~0 (shared
CLOCK_MONOTONIC) and ``gts`` just absorbs flush latency; across hosts
it is what makes lifecycle phases from different processes orderable.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Dict, List, Optional

from ray_tpu_torch.observability import timeline as timeline_mod

_EVENTS_MAX = 50_000
_SPANS_PER_JOB_MAX = 20_000
_JOBS_MAX = 64
_LIFECYCLE_ENTITIES_MAX = 25_000
_MARKS_PER_ENTITY_MAX = 64


class EventAggregator:
    def __init__(self) -> None:
        self.events: deque = deque(maxlen=_EVENTS_MAX)
        # job_id -> deque of span events (insertion-ordered; also the
        # job LRU: oldest job evicted past _JOBS_MAX)
        self.spans_by_job: "Dict[str, deque]" = {}
        # node_id -> latest reporter sample from that node's agent
        self.node_stats: Dict[str, dict] = {}
        # sender ident -> min-transit monotonic offset estimate
        self.clock_offsets: Dict[str, float] = {}
        # (etype, entity_id) -> lifecycle marks, LRU-bounded like jobs
        self.lifecycle: "Dict[tuple, deque]" = {}

    def _offset_for(self, sender: str, clock: Optional[dict]) -> float:
        if not clock or "mono" not in clock:
            return self.clock_offsets.get(sender, 0.0)
        off = time.monotonic() - float(clock["mono"])
        prev = self.clock_offsets.get(sender)
        if prev is None or off < prev:
            self.clock_offsets[sender] = off
            prev = off
        return prev

    def _index_lifecycle(self, ev: dict) -> None:
        key_field = "actor_id" if ev["type"] == "actor_lifecycle" \
            else "task_id"
        eid = ev.get(key_field)
        if not eid:
            return
        key = (ev["type"], eid)
        q = self.lifecycle.pop(key, None)
        if q is None:
            q = deque(maxlen=_MARKS_PER_ENTITY_MAX)
        self.lifecycle[key] = q
        while len(self.lifecycle) > _LIFECYCLE_ENTITIES_MAX:
            oldest = next(iter(self.lifecycle))
            del self.lifecycle[oldest]
        q.append(ev)

    def add(self, events: List[dict], clock: Optional[dict] = None) -> None:
        sender = events[0].get("worker", "") if events else ""
        offset = self._offset_for(sender, clock)
        for ev in events:
            if "mono" in ev and "gts" not in ev:
                ev["gts"] = float(ev["mono"]) + offset
            self.events.append(ev)
            etype = ev.get("type")
            if etype == "span":
                job = ev.get("job_id") or "_nojob"
                q = self.spans_by_job.pop(job, None)
                if q is None:
                    q = deque(maxlen=_SPANS_PER_JOB_MAX)
                # reinsert on every span so dict order is recency order
                # (true LRU): past _JOBS_MAX the evicted job is the one
                # longest idle, never a live job still producing spans
                self.spans_by_job[job] = q
                while len(self.spans_by_job) > _JOBS_MAX:
                    oldest = next(iter(self.spans_by_job))
                    del self.spans_by_job[oldest]
                q.append(ev)
            elif etype in ("actor_lifecycle", "task_lifecycle"):
                self._index_lifecycle(ev)

    def list_events(self, etype: Optional[str] = None,
                    job_id: Optional[str] = None,
                    limit: int = 1000) -> List[dict]:
        out = [
            e for e in self.events
            if (etype is None or e.get("type") == etype)
            and (job_id is None or e.get("job_id") == job_id)
        ]
        return out[-limit:]

    def get_trace(self, job_id: str) -> Dict[str, Any]:
        """The job's span records plus a parent→children index — enough
        for an exporter to rebuild the tree without re-deriving it."""
        spans = list(self.spans_by_job.get(job_id, ()))
        children: Dict[str, List[str]] = {}
        roots: List[str] = []
        for s in spans:
            pid = s.get("parent_span_id") or ""
            if pid:
                children.setdefault(pid, []).append(s["span_id"])
            else:
                roots.append(s["span_id"])
        return {"job_id": job_id, "spans": spans,
                "roots": roots, "children": children}

    # -- lifecycle timelines (observability/timeline.py analysis) ------
    def actor_timeline(self, actor_id: str) -> Dict[str, Any]:
        marks = list(self.lifecycle.get(("actor_lifecycle", actor_id), ()))
        tl = timeline_mod.build_timelines(marks)
        ordered = tl.get(actor_id, [])
        return {"actor_id": actor_id, "marks": ordered,
                "transitions": timeline_mod.transitions(ordered)}

    def lifecycle_summary(self, job_id: Optional[str] = None,
                          wall_s: Optional[float] = None,
                          etype: str = "actor_lifecycle") -> Dict[str, Any]:
        marks: List[dict] = []
        for (t, _eid), q in self.lifecycle.items():
            if t != etype:
                continue
            for ev in q:
                if job_id is None or ev.get("job_id") == job_id:
                    marks.append(ev)
        key = "actor_id" if etype == "actor_lifecycle" else "task_id"
        return timeline_mod.lifecycle_summary_doc(
            marks, wall_s=wall_s, etype=etype, key=key)

    def set_node_stats(self, node_id: str, stats: dict) -> None:
        self.node_stats[node_id] = dict(stats, reported_at=time.time())

    def list_node_stats(self) -> List[dict]:
        return [dict(s, node_id=n) for n, s in self.node_stats.items()]
