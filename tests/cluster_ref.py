"""Helpers of the port's multi-node tests: a ``Cluster`` of the port's
with the driver connected, its teardown checked, and the waits JAX's
tests use.

``data_cluster`` is the Data files' module fixture: JAX's local mode in
this process (collector paused) beside a two-node port cluster, whose
outcomes ``both`` holds against JAX's.

``warmed``, ``doomed_and_spare`` and ``kill`` are the fault files' node
pool: the node a case kills was added, and its zygote booted, while an
earlier case ran.

``port_cluster`` is the module-scoped cluster of each such file: a GCS and
one raylet a node spec, ``ray_tpu_torch.init(address=...)``, and at the end
``shutdown()`` of both with no process of the cluster left; its ``env``
(``RAY_TPU_<FLAG>`` variables) is set while the cluster lives, so every
daemon it spawns reads those flags, as JAX's fault tests set them with
``monkeypatch.setenv``. ``FAST_DEATH`` shortens the GCS's death detection
to 2 s (100 ms health checks, 20 misses; the raylet beats every 100 ms),
as JAX's fault tests lower the threshold to keep node deaths cheap.
"""

import contextlib
import gc
import subprocess
import time

import pytest

import ray_tpu
import ray_tpu.data  # noqa: F401
import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

# a pool node's CPUs: enough that the driver's cached idle leases never
# saturate it, so a task with soft affinity for it is granted there rather
# than spilled to the spare
POOL_CPUS = 4
FAST_DEATH = {"RAY_TPU_GCS_HEALTH_CHECK_PERIOD_MS": "100",
              "RAY_TPU_GCS_HEALTH_CHECK_FAILURE_THRESHOLD": "20",
              "RAY_TPU_RAYLET_HEARTBEAT_PERIOD_MS": "100"}


@contextlib.contextmanager
def collector_paused():
    """JAX's runtime with the cyclic collector off (ROADMAP.md Queue C).
    Kept here, not imported from the test modules: a worker that unpickles
    ``node_of`` imports this module, and theirs import JAX."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


def cluster_processes() -> str:
    return subprocess.run(["pgrep", "-af", "ray_tpu_torch._private"], capture_output=True,
                          text=True).stdout.strip()


@contextlib.contextmanager
def port_cluster(*nodes, gcs_storage=False, env=None, connect=True):
    """A port ``Cluster`` with one node a mapping of ``add_node`` kwargs
    (the first is the head), waited for, the driver connected, ``env``
    set while it lives."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in (env or {}).items():
            mp.setenv(name, value)
        cluster = Cluster(gcs_storage=gcs_storage)
        try:
            for kw in nodes:
                cluster.add_node(**kw)
            cluster.wait_for_nodes()
            if connect:
                ray_tpu_torch.init(address=cluster.address)
            yield cluster
        finally:
            try:
                ray_tpu_torch.shutdown()
            finally:
                cluster.shutdown()


def alive_nodes() -> list:
    return [n for n in ray_tpu_torch.nodes() if n["Alive"]]


def wait_alive(n: int, timeout: float = 30.0) -> None:
    """Until the GCS counts ``n`` nodes alive (JAX's ``_wait_dead``)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if len(alive_nodes()) == n:
            return
        time.sleep(0.1)
    raise TimeoutError(f"want {n} nodes alive, have {len(alive_nodes())}")


def gcs_client(cluster) -> RpcClient:
    return RpcClient("127.0.0.1", cluster.gcs_port)


def wait_drained(gcs, node_id: str, timeout: float = 45.0) -> dict:
    """Until the node is dead in the GCS's table (JAX's ``_wait_drained``)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        info = next(i for i in gcs.call("GetAllNodeInfo", timeout=10)
                    if i["NodeID"] == node_id)
        if not info["Alive"]:
            return info
        time.sleep(0.1)
    raise AssertionError(f"node {node_id[:12]} never finished draining")


@pytest.fixture(scope="module")
def data_cluster():
    with port_cluster({"num_cpus": 4}, {"num_cpus": 4}) as c:
        # both nodes' zygotes boot (torch's import) while JAX starts
        warm = [ray_tpu_torch.remote(lambda: 1).options(scheduling_strategy="SPREAD").remote()
                for _ in range(2)]
        with collector_paused():
            ray_tpu.init(local_mode=True)
        try:
            assert ray_tpu_torch.get(warm, timeout=120) == [1, 1]
            yield c
        finally:
            with collector_paused():
                ray_tpu.shutdown()


def both(fn):
    """``fn(data)`` through JAX's Data (local mode) and the port's (the
    cluster): (JAX's outcome, the port's)."""
    with collector_paused():
        ref = fn(ray_tpu.data)
    return ref, fn(ray_tpu_torch.data)


@ray_tpu_torch.remote
def node_of():
    return ray_tpu_torch.get_runtime_context().get_node_id()


def on(node, soft=True):
    return NodeAffinitySchedulingStrategy(node.node_id, soft=soft)


def warmed(cluster, node):
    """Wait for the node, then start its zygote (the first task there
    boots it) without waiting for the task."""
    cluster.wait_for_nodes()
    node.warm = node_of.options(scheduling_strategy=on(node, soft=False)).remote()
    return node


def doomed_and_spare(cluster):
    """The live worker node a case kills, and its replacement, added now."""
    doomed = cluster.nodes[-1]
    assert ray_tpu_torch.get(doomed.warm, timeout=120) == doomed.node_id
    return doomed, warmed(cluster, cluster.add_node(num_cpus=POOL_CPUS))


def kill(cluster, node):
    """Remove the node without a drain and wait until the GCS counts it
    dead."""
    cluster.remove_node(node)
    wait_alive(len(cluster.nodes))


@pytest.fixture(scope="module")
def drain_cluster():
    """The drain files' module cluster: a head that survives every case,
    fast death detection, and a client of its GCS."""
    with port_cluster({"num_cpus": 2}, env=FAST_DEATH) as c:
        gcs = gcs_client(c)
        yield c, gcs
        gcs.close()


@pytest.fixture
def with_n2(drain_cluster):
    """A drain case's own second node (resource n2: 10, as JAX's per-case
    fixture adds); removed after the case if it is still in the cluster's
    list (drained away, or the case failed first)."""
    c, gcs = drain_cluster
    n2 = c.add_node(num_cpus=2, resources={"n2": 10})
    c.wait_for_nodes()
    yield c, gcs, n2
    if n2 in c.nodes:
        kill(c, n2)


def wait_nodes_alive(cluster, n, timeout=60):
    """Until at least ``n`` nodes are alive in the GCS's table, which may
    be restarting (JAX's ``_wait_nodes_alive``)."""
    client = gcs_client(cluster)
    deadline = time.monotonic() + timeout
    try:
        while time.monotonic() < deadline:
            try:
                infos = client.call("GetAllNodeInfo", timeout=5)
                if sum(1 for i in infos if i["Alive"]) >= n:
                    return
            except Exception:  # noqa: BLE001
                pass  # the GCS is restarting: poll again
            time.sleep(0.1)
    finally:
        client.close()
    raise AssertionError("nodes did not re-register after the GCS restart")
