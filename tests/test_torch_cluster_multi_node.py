"""Cross-node scheduling and transfer on a multi-node ``Cluster`` of the
port's: tests/test_multi_node.py's module cases, with JAX's assertions, on
one module-scoped cluster of a head, node A and node B
(tests/test_torch_cluster_node_death.py has its node-death case).
"""

import numpy as np
import pytest

import ray_tpu_torch
from cluster_ref import port_cluster
from ray_tpu_torch.util.placement_group import (
    placement_group,
    placement_group_table,
    remove_placement_group,
)


@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 2, "resources": {"head": 1}},
                      {"num_cpus": 2, "resources": {"workerA": 1}},
                      {"num_cpus": 2, "resources": {"workerB": 1}}) as c:
        yield c


def test_cluster_sees_all_nodes(cluster):
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 6.0
    assert res["head"] == 1.0 and res["workerA"] == 1.0 and res["workerB"] == 1.0
    assert len([n for n in ray_tpu_torch.nodes() if n["Alive"]]) == 3


def test_task_spillback_to_remote_node(cluster):
    """A task whose custom resource exists only on a remote node spills
    there (reference: cluster_lease_manager.cc:420 spillback)."""
    @ray_tpu_torch.remote(resources={"workerA": 0.1})
    def node():
        return ray_tpu_torch.get_runtime_context().get_node_id()

    node_id = ray_tpu_torch.get(node.remote(), timeout=60)
    info = {n["NodeID"]: n for n in ray_tpu_torch.nodes()}
    assert info[node_id]["Resources"].get("workerA") == 1.0


def test_cross_node_object_transfer(cluster):
    """~40 MB made on node A, read by the driver and by a task on node B:
    the chunked pull path both ways."""
    @ray_tpu_torch.remote(resources={"workerA": 0.1})
    def produce():
        return np.arange(5_000_000, dtype=np.float64)  # 40 MB

    @ray_tpu_torch.remote(resources={"workerB": 0.1})
    def consume(arr):
        return float(arr.sum())

    ref = produce.remote()
    expected = float(np.arange(5_000_000, dtype=np.float64).sum())
    assert float(ray_tpu_torch.get(ref, timeout=120).sum()) == expected
    assert ray_tpu_torch.get(consume.remote(ref), timeout=120) == expected


def test_large_object_broadcast(cluster):
    """One 100 MB object read by tasks on every node."""
    ref = ray_tpu_torch.put(np.ones(12_500_000, dtype=np.float64))  # 100 MB

    @ray_tpu_torch.remote
    def touch(arr):
        return arr.nbytes

    sizes = ray_tpu_torch.get(
        [touch.options(resources={r: 0.1}).remote(ref) for r in ("head", "workerA", "workerB")],
        timeout=180)
    assert sizes == [100_000_000] * 3


def test_strict_spread_pg_across_nodes(cluster):
    pg = placement_group([{"CPU": 1}] * 3, strategy="STRICT_SPREAD")
    assert pg.wait(timeout_seconds=60)
    info = placement_group_table(pg)
    assert len(set(info["bundle_nodes"].values())) == 3, info["bundle_nodes"]
    remove_placement_group(pg)


def test_actor_on_remote_node_and_cross_node_calls(cluster):
    @ray_tpu_torch.remote(resources={"workerB": 0.1})
    class Remote:
        def __init__(self):
            self.data = np.arange(1_000_000, dtype=np.float32)  # lives on B

        def slice_sum(self, lo, hi):
            return float(self.data[lo:hi].sum())

    a = Remote.remote()
    assert ray_tpu_torch.get(a.slice_sum.remote(0, 10), timeout=120) == float(
        np.arange(10, dtype=np.float32).sum())
    ray_tpu_torch.kill(a)
