"""Event-type registry: the closed set of bus event schemas (copy of
ray_tpu/observability/schema.py).

Every ``record_event(etype, ...)`` call site must use a type declared
here (enforced by raycheck RC009) — an undeclared literal is a typo or
an undocumented schema, and a name built from an f-string is an
unbounded-cardinality bug waiting for the aggregator's memory. The
registry is a plain dict literal on purpose: RC009 reads it via AST,
no imports required.

The value strings document the payload contract a consumer (obsdump,
the aggregator, the state API) can rely on; they are not validated at
record time — recording stays two deque appends.
"""

from __future__ import annotations

EVENT_TYPES = {
    # tracing (observability/tracing.py — the one span producer)
    "span": "trace_id, span_id, parent_span_id, name, kind, job_id, "
            "ts, dur, status, attrs",
    # core-worker task path (gated on tracing.active())
    "task_state": "task_id, state, job_id, ...",
    "object_put": "size, job_id, inline",
    "object_get": "size, job_id, inline",
    # GCS control plane
    "actor_restart": "actor_id, restarts_left / exhausted",
    "NODE_DRAIN_START": "node_id, reason, deadline_s",
    "NODE_DRAIN_COMPLETE": "node_id, reason, duration_s, forced",
    # collectives (util/collective + observability/collective.py)
    "collective_op": "op, nbytes, world_size, rank, algo, codec, "
                     "topology, dur_s, mb_per_s, phases",
    "collective_epoch": "group, epoch, rank, members",
    "collective_failure": "group, epoch, rank, op, phase, then either "
                          "dead_ranks (confirmed death) or "
                          "suspect_ranks + confirmed=False (deadline "
                          "exhausted before the probe confirmed)",
    # control-plane lifecycle timelines (observability/timeline.py)
    "actor_lifecycle": "actor_id, phase, mono, job_id, node_id?",
    "task_lifecycle": "task_id, phase, mono, job_id",
    # flight-recorder dumps (observability/dump.py)
    "debug_dump": "reason, path, source",
    # podracer stage accounting (rllib/podracer/obs.py snapshots)
    "podracer_stage": "stages {name: {s, n}}, role",
}
