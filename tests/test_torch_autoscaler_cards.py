"""``LocalNodeProvider``'s card ownership on a port ``Cluster`` under
``RAY_TPU_FAKE_GPUS=2``: two ``gpu1`` launches own cards 0 and 1 (a task
leased on each node sees its card), a third raises naming the free cards, a
fractional card raises, a terminated node's card is given out again, and
``cluster=`` keeps the cards of the ``Cluster``'s own nodes out until one
leaves.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch.autoscaler import LocalNodeProvider
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

GPU1 = {"resources": {"CPU": 1.0, "GPU": 1.0}}


def visible_card():
    import os

    return os.environ.get("CUDA_VISIBLE_DEVICES")


def test_launched_nodes_own_distinct_cards(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FAKE_GPUS", "2")
    cluster = Cluster()
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes()
    provider = LocalNodeProvider(cluster.gcs_addr, cluster=cluster)
    try:
        (a,) = provider.create_node("gpu1", GPU1, labels={"node_type": "gpu1"})
        (b,) = provider.create_node("gpu1", GPU1, labels={"node_type": "gpu1"})
        assert (provider.node_gpu_ids(a), provider.node_gpu_ids(b)) == ([0], [1])
        with pytest.raises(ValueError, match=r"free cards are \[\]"):
            provider.create_node("gpu1", GPU1, labels={})
        with pytest.raises(ValueError, match="whole cards"):
            provider.create_node("half", {"resources": {"GPU": 0.5}}, labels={})
        ray_tpu_torch.init(address=cluster.address)
        seen = ray_tpu_torch.get([
            ray_tpu_torch.remote(num_gpus=1)(visible_card).options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(n, soft=False)).remote()
            for n in (a, b)], timeout=120)
        assert seen == ["0", "1"]  # each node's raylet leases its own card
        # a terminated node's card is given out again
        provider.terminate_node(a)
        (c,) = provider.create_node("gpu1", GPU1, labels={})
        assert provider.node_gpu_ids(c) == [0]
        assert set(provider.non_terminated_nodes()) == {b, c}
    finally:
        try:
            ray_tpu_torch.shutdown()
        finally:
            provider.shutdown()
            cluster.shutdown()


def test_cluster_nodes_cards_are_excluded(monkeypatch):
    monkeypatch.setenv("RAY_TPU_FAKE_GPUS", "2")
    cluster = Cluster()
    cluster.add_node(num_cpus=1)
    owner = cluster.add_node(num_cpus=1, num_gpus=1)  # card 0
    cluster.wait_for_nodes()
    provider = LocalNodeProvider(cluster.gcs_addr, cluster=cluster)
    blind = LocalNodeProvider(cluster.gcs_addr)
    try:
        assert owner.gpu_ids == [0]
        assert provider.free_gpu_ids() == [1] and blind.free_gpu_ids() == [0, 1]
        (a,) = provider.create_node("gpu1", GPU1, labels={})
        assert provider.node_gpu_ids(a) == [1]
        with pytest.raises(ValueError, match=r"free cards are \[\]"):
            provider.create_node("gpu1", GPU1, labels={})
        # the Cluster's node leaves (as a preempted node is dropped from
        # cluster.nodes): its card is free to launch on
        cluster.remove_node(owner)
        (b,) = provider.create_node("gpu1", GPU1, labels={})
        assert provider.node_gpu_ids(b) == [0]
    finally:
        provider.shutdown()
        cluster.shutdown()
