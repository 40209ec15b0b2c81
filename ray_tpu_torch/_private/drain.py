"""Graceful node drain — shared protocol constants + client helper (copy of
ray_tpu/_private/drain.py).

Reference: the `DrainNode` RPC of gcs_service.proto carries a reason
(`DRAIN_NODE_REASON_PREEMPTION` / `DRAIN_NODE_REASON_IDLE_TERMINATION`)
and a deadline; autoscaler_state_service and node_manager cooperate so a
draining node stops taking work, finishes what it can, and deregisters
before the machine disappears. TPU capacity makes this a first-class
path: a preempted pod slice gets a short notice and then every host in
it vanishes at once.

Drain lifecycle (our implementation):

  DrainNode(node_id, reason, deadline_s)          [any client -> GCS]
    GCS: node -> DRAINING, published on node_state, NODE_DRAIN_START
    GCS -> raylet Drain(reason, deadline_s): stop granting leases,
      redirect queued/new lease requests (spillback), let in-flight
      tasks run out
    GCS: migrate each ALIVE actor — worker DrainActor (finish accepted
      tasks, stop accepting) then restart per max_restarts elsewhere,
      watchers woken by the published actor_state event
    raylet: once task leases drain (or the deadline hits) push primary
      object copies to a surviving node, then NodeDrainComplete
    GCS: node -> dead, NODE_DRAIN_COMPLETE, actors already moved

A node is never stuck DRAINING: the GCS health watchdog force-completes
past deadline + grace, and a restarted GCS relearns the draining flag
from raylet heartbeats.
"""

from __future__ import annotations

from typing import Optional

# Drain reasons (mirroring autoscaler.proto's DrainNodeReason values).
REASON_PREEMPTION = "DRAIN_NODE_REASON_PREEMPTION"
REASON_IDLE_TERMINATION = "DRAIN_NODE_REASON_IDLE_TERMINATION"
# cluster teardown: quiesce only — skip the object push, the whole
# cluster is going away
REASON_CLUSTER_SHUTDOWN = "DRAIN_NODE_REASON_CLUSTER_SHUTDOWN"

# Event-bus types emitted by the GCS (rstate.list_events(etype=...)).
EVENT_DRAIN_START = "NODE_DRAIN_START"
EVENT_DRAIN_COMPLETE = "NODE_DRAIN_COMPLETE"


def drain_node(gcs_client, node_id: str, reason: str = REASON_PREEMPTION,
               deadline_s: Optional[float] = None,
               timeout: float = 10.0) -> dict:
    """Ask the GCS to gracefully drain ``node_id``. Returns the GCS
    reply ({"ok", "draining": [node_ids...]}); a preemption reason on a
    slice member drains the whole slice."""
    return gcs_client.call(
        "DrainNode", node_id=node_id, reason=reason,
        deadline_s=deadline_s, timeout=timeout,
    )
