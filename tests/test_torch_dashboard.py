"""The dashboard's HTTP API and the per-node agent: JAX's
tests/test_dashboard.py ``TestHttpApi`` and ``TestNodeAgent`` cases on a port
``Cluster`` with a port ``DashboardHead``, held against JAX's head on a JAX
``Cluster``: the same routes give the same status codes and the same JSON
keys, and every node registers its agent (``AgentPort``), whose stats, logs
and raylet state the head proxies. The job cases are
tests/test_torch_dashboard_jobs.py's.

Both heads serve from threads of this process; JAX's cluster runs with the
collector paused (ROADMAP.md Queue C).
"""

import time
import urllib.request

import pytest

import ray_tpu_torch
from front_door_ref import both_clusters, http_get
from ray_tpu.dashboard import DashboardHead as JaxDashboardHead
from ray_tpu_torch._private.worker import ADDRESS_ENV
from ray_tpu_torch.dashboard import DashboardHead
from ray_tpu_torch.dashboard.agent import NodeAgent

HEADS = {"jax": JaxDashboardHead, "port": DashboardHead}
ROUTES = ["/api/version", "/api/nodes", "/api/actors", "/api/tasks", "/api/cluster_status",
          "/api/v0/events", "/api/v0/node_stats", "/api/jobs", "/api/nope", "/api/jobs/nojob",
          "/api/nodes/ffff/stats"]
AGENT_ROUTES = ["stats", "logs", "raylet", "health", "logs/raylet.log", "nope"]


@pytest.fixture(scope="module")
def clusters():
    with both_clusters(num_cpus=2) as made:
        yield made


@pytest.fixture(scope="module")
def heads(clusters):
    made = {}
    try:
        for side, cls in HEADS.items():
            made[side] = cls(clusters[side].gcs_addr, port=0)
        yield made
    finally:
        for head in made.values():
            head.shutdown()


def shape(body):
    """A JSON body's keys: a dict's, or its first element's for a list."""
    if isinstance(body, dict):
        return sorted(body)
    if isinstance(body, list) and body and isinstance(body[0], dict):
        return ["[]"] + sorted(body[0])
    return type(body).__name__


def both(heads, route):
    return {side: http_get(head.address + route) for side, head in heads.items()}


@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_jax(heads, route):
    got = both(heads, route)
    assert {s: (code, shape(body)) for s, (code, body) in got.items()} == {
        s: (got["jax"][0], shape(got["jax"][1])) for s in got}


def test_version_and_nodes(heads):
    for side, head in heads.items():
        code, body = http_get(head.address + "/api/version")
        assert code == 200 and "version" in body, side
        code, nodes = http_get(head.address + "/api/nodes")
        assert len(nodes) == 1 and nodes[0]["Alive"], side


def test_html_overview(heads):
    for head in heads.values():
        with urllib.request.urlopen(head.address + "/") as r:
            html = r.read().decode()
        assert "Nodes (1)" in html and "Jobs" in html


def test_cluster_status_endpoint(heads):
    for head in heads.values():
        code, status = http_get(head.address + "/api/cluster_status")
        assert code == 200 and status["nodes"] and "pending_actors" in status


def test_node_stats_reported_by_the_agent(heads):
    """The agent's reporter loop ships a sample to the GCS every
    ``REPORT_PERIOD_S``; the head serves them, with the same keys."""
    deadline = time.monotonic() + 4 * NodeAgent.REPORT_PERIOD_S
    while time.monotonic() < deadline:
        got = both(heads, "/api/v0/node_stats")
        if all(body for _, body in got.values()):
            break
        time.sleep(0.2)
    assert shape(got["port"][1]) == shape(got["jax"][1]) != "list"
    stats = got["port"][1][0]
    assert 0 < stats["mem_available"] <= stats["mem_total"] and stats["cpu_percent"] >= 0


@pytest.mark.parametrize("sub", AGENT_ROUTES)
def test_agent_via_head_proxy_matches_jax(heads, sub):
    """Every node registers its agent; the head proxies
    ``/api/nodes/<id>/<sub>`` to it: the same codes and keys as JAX's, the
    node's own id in its stats, health and raylet state."""
    got = {}
    for side, head in heads.items():
        _, nodes = http_get(head.address + "/api/nodes")
        assert nodes and all(n.get("AgentPort") for n in nodes), nodes
        nid = nodes[0]["NodeID"]
        code, body = http_get(f"{head.address}/api/nodes/{nid}/{sub}")
        got[side] = (code, shape(body))
        if sub in ("stats", "health", "raylet"):
            assert code == 200 and body["node_id"] == nid, (side, body)
        if sub == "stats":
            assert body["num_workers"] >= 0
        if sub == "raylet":
            assert "num_oom_kills" in body
    assert got["port"] == got["jax"]


def test_init_joins_ray_tpu_address(clusters, monkeypatch):
    """``init()`` with no address connects to ``$RAY_TPU_ADDRESS``, the
    variable the job manager exports to a job, and starts nothing: the
    driver sees the cluster's one node. JAX's ``init()`` reads no such
    variable (tests/test_torch_dashboard_jobs.py shows its job on a fresh
    cluster)."""
    cluster = clusters["port"]
    monkeypatch.setenv(ADDRESS_ENV, cluster.address)
    ray_tpu_torch.init()
    try:
        assert [n["NodeID"] for n in ray_tpu_torch.nodes()] == [cluster.nodes[0].node_id]
        assert ray_tpu_torch.get(ray_tpu_torch.remote(lambda: 7).remote(), timeout=60) == 7
    finally:
        ray_tpu_torch.shutdown()
