"""Graceful drain on a multi-node ``Cluster`` of the port's:
tests/test_drain.py's TestGracefulDrain cases of the lease path (the
lifecycle and its events, in-flight tasks finishing) and
TestWarmLeaseDeadWorker, with JAX's assertions, on
one module-scoped cluster. Each drain case adds its own second node (n2,
resource n2: 10), as JAX's per-case fixture does, and drains it away;
the head survives. tests/test_torch_cluster_drain_actors.py has the
actor case and a draining node refusing leases, _drain_objects.py the
object and sustained-load cases, _drain_recall.py the recall race.
"""

import os
import signal
import time

import ray_tpu_torch
from cluster_ref import drain_cluster, wait_drained, with_n2  # noqa: F401 (fixtures)
from ray_tpu_torch._private.drain import (
    EVENT_DRAIN_COMPLETE,
    EVENT_DRAIN_START,
    REASON_PREEMPTION,
    drain_node,
)
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch.util import state as rstate


def test_drain_lifecycle_and_events(with_n2):
    c, gcs, n2 = with_n2

    @ray_tpu_torch.remote(max_retries=3)
    def f(x):
        return x + 1

    assert ray_tpu_torch.get([f.remote(i) for i in range(8)], timeout=120) == list(range(1, 9))
    rep = drain_node(gcs, n2.node_id, reason=REASON_PREEMPTION, deadline_s=10.0)
    assert rep["ok"] and n2.node_id in rep["draining"]
    info = wait_drained(gcs, n2.node_id)
    assert not info["Alive"] and not info["Draining"]
    events = rstate.list_events()
    types = [e["type"] for e in events]
    assert EVENT_DRAIN_START in types
    assert types.count(EVENT_DRAIN_COMPLETE) == 1
    start = next(e for e in events if e["type"] == EVENT_DRAIN_START)
    assert start["node_id"] == n2.node_id and start["reason"] == REASON_PREEMPTION
    # the raylet deregistered and exited on its own — no SIGKILL
    deadline = time.monotonic() + 10
    while n2.proc.poll() is None and time.monotonic() < deadline:
        time.sleep(0.1)
    assert n2.proc.poll() is not None
    # work continues on the survivor
    assert ray_tpu_torch.get([f.remote(i) for i in range(4)], timeout=120) == [1, 2, 3, 4]


def test_in_flight_tasks_finish_within_deadline(with_n2):
    c, gcs, n2 = with_n2

    @ray_tpu_torch.remote(max_retries=0, resources={"n2": 1})
    def slow(x):
        time.sleep(1.0)
        return x * 7

    refs = [slow.remote(i) for i in range(2)]
    # both leases GRANTED on n2 before the drain lands
    raylet2 = RpcClient("127.0.0.1", n2.raylet_port)
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if raylet2.call("GetState", timeout=10)["num_leases"] >= 2:
                break
            time.sleep(0.1)
    finally:
        raylet2.close()
    drain_node(gcs, n2.node_id, deadline_s=20.0)
    # max_retries=0: only a graceful drain makes these succeed
    assert ray_tpu_torch.get(refs, timeout=120) == [0, 7]
    wait_drained(gcs, n2.node_id)


def test_sigkilled_warm_worker_falls_back_to_fresh_lease(drain_cluster):
    """A push against a cached lease whose worker was SIGKILLed re-leases
    instead of surfacing ConnectionError, even at max_retries=0."""
    @ray_tpu_torch.remote(max_retries=0)
    def f(x):
        return os.getpid(), x * 3

    pid1, v1 = ray_tpu_torch.get(f.remote(1), timeout=120)
    assert v1 == 3
    os.kill(pid1, signal.SIGKILL)  # between two sync calls
    time.sleep(0.2)
    pid2, v2 = ray_tpu_torch.get(f.remote(2), timeout=120)
    assert v2 == 6 and pid2 != pid1
