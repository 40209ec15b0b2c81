"""GCS fault tolerance on a ``Cluster`` of the port's with file-backed GCS
storage: tests/test_gcs_restart.py's restart cases (state after a
snapshot, a pending actor scheduled after the restart), with JAX's
assertions, on one module-scoped cluster. The control plane restarts on
its port and replays its tables; raylets re-register by heartbeat.
tests/test_torch_cluster_gcs_wal.py has the immediate-kill cases.
"""

import time

import pytest

import ray_tpu_torch
from cluster_ref import gcs_client, port_cluster, wait_nodes_alive


@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 4}, gcs_storage=True) as c:
        yield c


@ray_tpu_torch.remote
def f(x):
    return x * 3


def test_state_survives_restart(cluster):
    @ray_tpu_torch.remote
    class Registry:
        def __init__(self):
            self.items = {}

        def put(self, k, v):
            self.items[k] = v
            return True

        def get(self, k):
            return self.items.get(k)

    reg = Registry.options(name="registry", lifetime="detached").remote()
    assert ray_tpu_torch.get(reg.put.remote("a", 1))
    gcs = gcs_client(cluster)
    gcs.call("KVPut", ns="user", key="k1", value=b"v1", overwrite=True, timeout=10)
    time.sleep(1.5)  # let the snapshot flush (0.5 s loop)
    cluster.restart_gcs()
    wait_nodes_alive(cluster, 1)
    gcs2 = gcs_client(cluster)
    try:
        assert gcs2.call("KVGet", ns="user", key="k1", timeout=10) == b"v1"
    finally:
        gcs.close()
        gcs2.close()
    # the named detached actor replayed and still serving
    h = ray_tpu_torch.get_actor("registry")
    assert ray_tpu_torch.get(h.get.remote("a"), timeout=60) == 1
    assert ray_tpu_torch.get(f.remote(7), timeout=60) == 21


def test_pending_actor_scheduled_after_restart(cluster):
    @ray_tpu_torch.remote(resources={"special": 1})
    class Special:
        def ping(self):
            return "pong"

    Special.options(name="special_actor", lifetime="detached").remote()
    time.sleep(1.5)  # snapshot the PENDING actor
    cluster.restart_gcs()
    wait_nodes_alive(cluster, 1)
    # a node with the resource: the replayed pending actor lands there
    cluster.add_node(num_cpus=1, resources={"special": 1})
    h = ray_tpu_torch.get_actor("special_actor")
    assert ray_tpu_torch.get(h.ping.remote(), timeout=90) == "pong"
