"""The GCS killed with no settling time, on a ``Cluster`` of the port's
with file-backed GCS storage: tests/test_gcs_restart.py's write-ahead-log
cases (acknowledged mutations and a killed name survive a SIGKILL) and a
drain racing the crash, with JAX's assertions, on one module-scoped
cluster (tests/test_torch_cluster_gcs_restart.py has the helpers' source
and the snapshot cases).
"""

import time

import pytest

import ray_tpu_torch
from cluster_ref import gcs_client, port_cluster, wait_nodes_alive
from ray_tpu_torch._private.drain import REASON_PREEMPTION


@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 4}, gcs_storage=True) as c:
        yield c


@ray_tpu_torch.remote
def f(x):
    return x * 3


def test_wal_no_lost_updates_on_immediate_kill(cluster):
    """Mutations acknowledged right before a SIGKILL survive it (the
    write-ahead log)."""
    @ray_tpu_torch.remote
    class KV:
        def __init__(self):
            self.d = {}

        def put(self, k, v):
            self.d[k] = v
            return "ok"

    h = KV.options(name="walkv", lifetime="detached").remote()
    assert ray_tpu_torch.get(h.put.remote("k", 42), timeout=60) == "ok"
    gcs = gcs_client(cluster)
    try:
        assert gcs.call("KVPut", ns="app", key="last", value=b"v1", timeout=10)["added"]
        jid = gcs.call("RegisterJob", driver_addr=("127.0.0.1", 1), timeout=10)["job_id"]
        gcs.call("MarkJobFinished", job_id=jid, timeout=10)
        cluster.kill_gcs()  # SIGKILL, zero settling time
        cluster._start_gcs()
        wait_nodes_alive(cluster, len(cluster.nodes))
        assert gcs.call_retrying("KVGet", ns="app", key="last", timeout=10) == b"v1"
        jobs = {j["job_id"]: j for j in gcs.call_retrying("ListJobs", timeout=10)}
        assert jobs[jid]["state"] == "FINISHED", "finished state was lost"
    finally:
        gcs.close()
    h2 = ray_tpu_torch.get_actor("walkv")
    assert ray_tpu_torch.get(h2.put.remote("k2", 1), timeout=60) == "ok"


def test_named_actor_kill_survives_replay(cluster):
    """A killed name's deletion is durable: a crash right after the
    acknowledged kill does not resurrect it on replay."""
    @ray_tpu_torch.remote
    class Named:
        def ping(self):
            return "pong"

    h = Named.options(name="doomed", lifetime="detached").remote()
    assert ray_tpu_torch.get(h.ping.remote(), timeout=60) == "pong"
    ray_tpu_torch.kill(h, no_restart=True)
    gcs = gcs_client(cluster)
    try:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if gcs.call("GetActorByName", name="doomed", namespace="default",
                        timeout=10) is None:
                break
            time.sleep(0.2)
        cluster.kill_gcs()
        cluster._start_gcs()
        wait_nodes_alive(cluster, len(cluster.nodes))
        assert gcs.call_retrying("GetActorByName", name="doomed", namespace="default",
                                 timeout=10) is None
    finally:
        gcs.close()
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("doomed")


def test_gcs_restart_racing_in_flight_drain(cluster):
    """A drain begun right before a GCS crash ends after the restart: the
    node is dead, gone or alive and not draining, never stuck DRAINING."""
    n2 = cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    gcs = gcs_client(cluster)
    try:
        rep = gcs.call("DrainNode", node_id=n2.node_id, reason=REASON_PREEMPTION,
                       deadline_s=8.0, timeout=10)
        assert rep["ok"]
        cluster.kill_gcs()  # SIGKILL while the drain is in flight
        time.sleep(1.0)
        cluster._start_gcs()
        wait_nodes_alive(cluster, 1)
        deadline = time.monotonic() + 30
        final, seen_draining = None, False
        while time.monotonic() < deadline:
            infos = gcs.call_retrying("GetAllNodeInfo", timeout=10)
            info = next((i for i in infos if i["NodeID"] == n2.node_id), None)
            if info is not None and not info["Draining"]:
                final = info
                break
            seen_draining = seen_draining or info is not None
            time.sleep(0.3)
        assert final is not None or not seen_draining, "node stuck DRAINING after GCS restart"
    finally:
        gcs.close()
    assert ray_tpu_torch.get(f.remote(2), timeout=120) == 6
