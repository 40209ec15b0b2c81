"""The drain's recall race on a multi-node ``Cluster`` of the port's:
tests/test_drain.py::TestDrainRecallFeasibility with JAX's assertions. A
task pinned by a resource that only the draining node has gets its push
refused (node_draining); re-leasing it is infeasible, so it must finish on
that node under the drain's deadline. Every PushTask waits 300 ms on the
worker (``testing_rpc_failure``, JAX's setting), which holds the race
window open; two rounds, each with its own n2, on one module cluster.
"""

import time

import pytest

import ray_tpu_torch
from cluster_ref import gcs_client, port_cluster, wait_drained
from ray_tpu_torch._private.drain import drain_node
from ray_tpu_torch._private.rpc import RpcClient


@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 2}, env={
            "RAY_TPU_TESTING_RPC_FAILURE": "PushTask=1:300,PushTaskBatch=1:300"}) as c:
        gcs = gcs_client(c)
        yield c, gcs
        gcs.close()


@pytest.mark.parametrize("round_", [0, 1])
def test_recalled_pinned_task_finishes_on_draining_node(cluster, round_):
    c, gcs = cluster
    n2 = c.add_node(num_cpus=2, resources={"n2": 10})
    c.wait_for_nodes()

    @ray_tpu_torch.remote(max_retries=0, resources={"n2": 1})
    def pinned(x):
        time.sleep(0.3)
        return x * 7

    refs = [pinned.remote(i) for i in range(2)]
    # the leases GRANTED on n2: the pushes are then in their 300 ms delay
    raylet2 = RpcClient("127.0.0.1", n2.raylet_port)
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if raylet2.call("GetState", timeout=10)["num_leases"] >= 2:
                break
            time.sleep(0.05)
    finally:
        raylet2.close()
    drain_node(gcs, n2.node_id, deadline_s=20.0)
    # no other node has {"n2": 1}: drain_final lands them back on n2
    assert ray_tpu_torch.get(refs, timeout=120) == [0, 7]
    wait_drained(gcs, n2.node_id)
    c.nodes.remove(n2)
