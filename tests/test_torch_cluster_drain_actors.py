"""Graceful drain of a node with an actor on a multi-node ``Cluster`` of
the port's: tests/test_drain.py::TestGracefulDrain::test_actor_restarts_elsewhere_on_drain
with JAX's assertions (every call during and after the drain succeeds),
its n2 added and drained as tests/test_torch_cluster_drain.py says; and
TestGracefulDrain's draining node refusing a lease with a redirect. The
port's actor dispatcher leaves a call whose push is in flight to the push
(a refusal resends it to the new incarnation); the JAX package fails it
as lost when the drained worker answers "no record", which made JAX's
case flaky (ROADMAP.md Queue C). _drain_objects.py has the object and
load cases.
"""

import os

import ray_tpu_torch
from cluster_ref import drain_cluster, kill, wait_drained, with_n2  # noqa: F401 (fixtures)
from ray_tpu_torch._private.drain import REASON_PREEMPTION, drain_node
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch.util import state as rstate
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy


def test_actor_restarts_elsewhere_on_drain(with_n2):
    c, gcs, n2 = with_n2

    @ray_tpu_torch.remote(max_restarts=2)
    class Counter:
        def __init__(self):
            self.n = 0

        def inc(self):
            self.n += 1
            return self.n

        def node(self):
            return os.environ.get("RAY_TPU_NODE_ID")

    # SOFT affinity lands the actor on n2 but lets the restart go anywhere
    a = Counter.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
        n2.node_id, soft=True)).remote()
    assert ray_tpu_torch.get(a.inc.remote(), timeout=60) >= 1
    assert ray_tpu_torch.get(a.node.remote(), timeout=60) == n2.node_id
    drain_node(gcs, n2.node_id, deadline_s=15.0)
    # every call during and after the drain succeeds; the actor restarts
    # on the survivor (state resets with the new incarnation)
    vals = [ray_tpu_torch.get(a.inc.remote(), timeout=120) for _ in range(5)]
    assert all(isinstance(v, int) and v >= 1 for v in vals)
    wait_drained(gcs, n2.node_id)
    assert ray_tpu_torch.get(a.node.remote(), timeout=120) == c.nodes[0].node_id
    assert rstate.get_actor(a._actor_id.hex())["num_restarts"] >= 1
    ray_tpu_torch.kill(a)


def test_draining_node_takes_no_new_leases(with_n2):
    c, gcs, n2 = with_n2
    raylet2 = RpcClient("127.0.0.1", n2.raylet_port)
    try:
        rep = raylet2.call("Drain", reason=REASON_PREEMPTION, deadline_s=30.0, timeout=10)
        assert rep["ok"]
        lease = raylet2.call("RequestWorkerLease", resources={"CPU": 1},
                             scheduling_class=("t",), job_id="j", timeout=15)
        assert not lease.get("granted")
        assert lease.get("draining")
        # a survivor exists, so the rejection carries a redirect
        assert tuple(lease["spillback"]) == ("127.0.0.1", c.nodes[0].raylet_port)
    finally:
        raylet2.close()
    kill(c, n2)  # the GCS never drained it: the next case wants it dead
