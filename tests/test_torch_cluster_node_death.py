"""Objects lost with their node on a multi-node ``Cluster`` of the
port's: tests/test_object_reconstruction.py::test_lost_put_is_not_reconstructable
and tests/test_multi_node.py::test_survive_worker_node_death with JAX's
assertions, and an output whose only copy dies, rebuilt by one
resubmission, on one module-scoped cluster. Nodes die as in
tests/test_torch_cluster_faults.py.
"""

import numpy as np
import pytest

import ray_tpu_torch
from cluster_ref import FAST_DEATH, POOL_CPUS, doomed_and_spare, kill, on, port_cluster, warmed

@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 0, "resources": {"head": 1}}, env=FAST_DEATH) as c:
        warmed(c, c.add_node(num_cpus=POOL_CPUS))
        yield c


def test_lost_put_is_not_reconstructable(cluster):
    """A put has no lineage: losing its node is a permanent
    ObjectLostError (the reference's semantics)."""
    doomed, _ = doomed_and_spare(cluster)

    @ray_tpu_torch.remote
    def put_remote():
        return ray_tpu_torch.put(np.ones(200_000))  # the put lives on doomed

    inner = ray_tpu_torch.get(put_remote.options(scheduling_strategy=on(doomed)).remote(),
                              timeout=90)
    kill(cluster, doomed)
    with pytest.raises(ray_tpu_torch.exceptions.ObjectLostError):
        ray_tpu_torch.get(inner, timeout=60)


def test_survive_worker_node_death(cluster):
    """The node a task is pinned to dies: its object is lost with a clear
    error (its re-run is infeasible), and new work runs on the
    survivors."""
    doomed, _ = doomed_and_spare(cluster)

    @ray_tpu_torch.remote
    def produce():
        return np.ones(1_000_000)  # 8 MB, in the doomed node's store

    # pinned to the node as JAX's custom resource pins it: hard affinity
    produce = produce.options(scheduling_strategy=on(doomed, soft=False))
    assert ray_tpu_torch.get(produce.remote(), timeout=90).shape == (1_000_000,)
    ref2 = produce.remote()
    ray_tpu_torch.wait([ref2], timeout=60)
    kill(cluster, doomed)
    with pytest.raises((ray_tpu_torch.exceptions.ObjectLostError,
                        ray_tpu_torch.exceptions.RayTaskError)):
        ray_tpu_torch.get(ref2, timeout=30)

    @ray_tpu_torch.remote
    def alive_task():
        return "ok"

    assert ray_tpu_torch.get(alive_task.remote(), timeout=60) == "ok"


def test_reconstruct_an_output_never_fetched(cluster):
    """The output's only copy is on the node that dies (the driver only
    waited for it): the owner resubmits its task once."""
    doomed, _ = doomed_and_spare(cluster)

    @ray_tpu_torch.remote(num_returns=2)
    def produce():
        return ray_tpu_torch.get_runtime_context().get_node_id(), np.full(300_000, 3.0)

    where, ref = produce.options(scheduling_strategy=on(doomed)).remote()
    assert ray_tpu_torch.wait([ref], timeout=90, fetch_local=False)[0] == [ref]
    assert ray_tpu_torch.get(where, timeout=30) == doomed.node_id
    core = ray_tpu_torch._private.worker.global_worker.core
    before = core.reconstructions
    kill(cluster, doomed)
    assert float(ray_tpu_torch.get(ref, timeout=120).sum()) == 3.0 * 300_000
    assert core.reconstructions == before + 1
