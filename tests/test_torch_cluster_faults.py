"""Lineage reconstruction on a multi-node ``Cluster`` of the port's:
tests/test_object_reconstruction.py's first two cases with JAX's
assertions, on one module-scoped cluster
(tests/test_torch_cluster_node_death.py has the third, an output whose
only copy dies, and a node's death; tests/test_torch_cluster_spilling.py
the spilling cases).

The head holds the driver and no CPU; worker nodes come and go. Each case
kills a node holding an object (no drain) and waits for the GCS to count
it dead (``FAST_DEATH``: 2 s). Where JAX's case relies on the doomed node
being the only one with CPUs, the producer here asks for it by soft node
affinity, so the object lands there and its re-run may go anywhere. The
next case's node is added, and its zygote warmed, before a node is
killed, so no case waits for a cold node.
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


def test_reconstruct_lost_task_output(cluster):
    """Kill the node holding a task's output; get still returns it."""
    doomed, _ = doomed_and_spare(cluster)

    @ray_tpu_torch.remote
    def produce(tag):
        return np.full(300_000, 7.0)  # 2.4 MB -> the store, on doomed

    ref = produce.options(scheduling_strategy=on(doomed)).remote("a")
    assert float(ray_tpu_torch.get(ref, timeout=90).sum()) == 7.0 * 300_000
    kill(cluster, doomed)
    # the owner (driver) reconstructs by resubmitting produce, or reads
    # the copy its first get left on the head
    assert float(ray_tpu_torch.get(ref, timeout=120).sum()) == 7.0 * 300_000


def test_reconstruct_chained_dependency(cluster):
    """Kill the node holding both an intermediate and its consumer's
    output: the consumer's re-run walks back to the intermediate."""
    doomed, _ = doomed_and_spare(cluster)

    @ray_tpu_torch.remote
    def base():
        return np.arange(200_000, dtype=np.float64)  # 1.6 MB

    @ray_tpu_torch.remote
    def double(x):
        return x * 2.0

    b = base.options(scheduling_strategy=on(doomed)).remote()
    d = double.options(scheduling_strategy=on(doomed)).remote(b)
    expected = float((np.arange(200_000, dtype=np.float64) * 2.0).sum())
    assert float(ray_tpu_torch.get(d, timeout=90).sum()) == expected
    kill(cluster, doomed)
    assert float(ray_tpu_torch.get(d, timeout=180).sum()) == expected
