"""Scheduling strategies on a two-node ``Cluster`` of the port's:
tests/test_scheduling_strategies.py's cases (node affinity hard and soft,
SPREAD, actor strategies, node labels, and a hard label's fitting node),
with JAX's assertions, on one module-scoped cluster: a head and n2
(labelled region=eu, tier=gold), then two pool=a nodes for the last case.
"""

import os
import time

import pytest

import ray_tpu_torch
from cluster_ref import port_cluster
from ray_tpu_torch.util.scheduling_strategies import (
    NodeAffinitySchedulingStrategy,
    NodeLabelSchedulingStrategy,
)


@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 2},
                      {"num_cpus": 2, "labels": {"region": "eu", "tier": "gold"}}) as c:
        yield c


@ray_tpu_torch.remote
def where():
    return os.environ["RAY_TPU_NODE_ID"]


def test_hard_affinity_pins_to_node(cluster):
    n2 = cluster.nodes[1]
    f = where.options(scheduling_strategy=NodeAffinitySchedulingStrategy(n2.node_id))
    assert ray_tpu_torch.get(f.remote(), timeout=90) == n2.node_id


def test_hard_affinity_to_dead_node_fails(cluster):
    f = where.options(scheduling_strategy=NodeAffinitySchedulingStrategy("f" * 32))
    with pytest.raises(Exception, match="not alive"):
        ray_tpu_torch.get(f.remote(), timeout=90)


def test_soft_affinity_falls_back(cluster):
    f = where.options(scheduling_strategy=NodeAffinitySchedulingStrategy("f" * 32, soft=True))
    assert len(ray_tpu_torch.get(f.remote(), timeout=90)) > 0


def test_spread_uses_multiple_nodes(cluster):
    @ray_tpu_torch.remote(scheduling_strategy="SPREAD")
    def slow_where():
        time.sleep(0.4)
        return os.environ["RAY_TPU_NODE_ID"]

    nodes = set(ray_tpu_torch.get([slow_where.remote() for _ in range(8)], timeout=120))
    assert len(nodes) == 2


@ray_tpu_torch.remote
class Where:
    def node(self):
        return os.environ["RAY_TPU_NODE_ID"]


@pytest.mark.parametrize("strategy", ["affinity", "label"])
def test_actor_strategies(cluster, strategy):
    n2 = cluster.nodes[1]
    st = (NodeAffinitySchedulingStrategy(n2.node_id) if strategy == "affinity"
          else NodeLabelSchedulingStrategy(hard={"tier": "gold"}))
    a = Where.options(scheduling_strategy=st).remote()
    assert ray_tpu_torch.get(a.node.remote(), timeout=90) == n2.node_id
    ray_tpu_torch.kill(a)


def test_hard_label_match(cluster):
    f = where.options(scheduling_strategy=NodeLabelSchedulingStrategy(hard={"region": "eu"}))
    assert ray_tpu_torch.get(f.remote(), timeout=90) == cluster.nodes[1].node_id


def test_hard_label_mismatch_fails(cluster):
    f = where.options(scheduling_strategy=NodeLabelSchedulingStrategy(hard={"region": "mars"}))
    with pytest.raises(Exception, match="labels"):
        ray_tpu_torch.get(f.remote(), timeout=90)


def test_soft_label_falls_back(cluster):
    f = where.options(scheduling_strategy=NodeLabelSchedulingStrategy(
        hard={"region": "mars"}, soft=True))
    assert len(ray_tpu_torch.get(f.remote(), timeout=90)) > 0


def test_label_match_prefers_fitting_node(cluster):
    """A hard label constraint lands on a matching node whose totals fit
    the request, never on an undersized match."""
    cluster.add_node(num_cpus=1, labels={"pool": "a"})
    big = cluster.add_node(num_cpus=4, labels={"pool": "a"})
    cluster.wait_for_nodes()
    f = where.options(num_cpus=3,
                      scheduling_strategy=NodeLabelSchedulingStrategy(hard={"pool": "a"}))
    refs = [f.remote() for _ in range(4)]
    assert set(ray_tpu_torch.get(refs, timeout=120)) == {big.node_id}
