"""``ray_tpu_torch.cluster_utils.Cluster``, the port of
ray_tpu/cluster_utils.py: nodes added, waited for, removed, the GCS killed
and restarted, on one module-scoped cluster; and each node's cards.

The host has 3 fake cards here (``RAY_TPU_FAKE_GPUS=3``): the head takes
one, a second node two, so their ids are disjoint ([0] and [1, 2]) and a
lease's ``CUDA_VISIBLE_DEVICES`` names the host card; asking for a card
more than the host has left raises, and a removed node's cards are free
again. Then ``build_llm_processor`` asking for a card it is not given:
the stage raises, nothing falls back to the CPU.
"""

import os

import pytest

import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401
from cluster_ref import FAST_DEATH, alive_nodes, port_cluster, wait_alive
from ray_tpu_torch.llm import LLMConfig, build_llm_processor


@pytest.fixture(scope="module")
def cluster():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_TPU_FAKE_GPUS", "3")
        with port_cluster({"num_cpus": 2, "num_gpus": 1}, gcs_storage=True,
                          env=FAST_DEATH) as c:
            yield c


@ray_tpu_torch.remote(num_gpus=1)
class Card:
    def facts(self):
        ctx = ray_tpu_torch.get_runtime_context()
        return (os.environ["CUDA_VISIBLE_DEVICES"], ctx.get_node_id(),
                ctx.get_assigned_resources()["gpu_ids"])


def test_add_wait_and_cards_disjoint(cluster):
    head = cluster.nodes[0]
    n2 = cluster.add_node(num_cpus=2, num_gpus=2, resources={"n2": 1})
    cluster.wait_for_nodes()
    assert head.is_head and not n2.is_head
    assert (head.gpu_ids, n2.gpu_ids) == ([0], [1, 2])
    res = ray_tpu_torch.cluster_resources()
    assert res["CPU"] == 4.0 and res["GPU"] == 3.0 and res["n2"] == 1.0
    assert len(alive_nodes()) == 2
    # every card leased at once: each host card once, on the node owning it
    cards = [Card.remote() for _ in range(3)]
    facts = ray_tpu_torch.get([c.facts.remote() for c in cards], timeout=120)
    owner = {"0": head.node_id, "1": n2.node_id, "2": n2.node_id}
    assert sorted(v for v, _, _ in facts) == ["0", "1", "2"]
    assert all(node == owner[v] and ids == [int(v)] for v, node, ids in facts)
    for c in cards:
        ray_tpu_torch.kill(c)
    # the freed cards are leased again at once: a lease queued behind a
    # card still held moves to a node where one has come free (the JAX
    # package's raylet holds it for its 50 s lease timeout)
    cards = [Card.remote() for _ in range(3)]
    facts = ray_tpu_torch.get([c.facts.remote() for c in cards], timeout=20)
    assert sorted(v for v, _, _ in facts) == ["0", "1", "2"]
    for c in cards:
        ray_tpu_torch.kill(c)


def test_too_many_cards_raise(cluster):
    assert cluster.free_gpu_ids() == []
    with pytest.raises(ValueError, match="3 cards and 0 are free"):
        cluster.add_node(num_gpus=1)
    with pytest.raises(ValueError, match="whole cards"):
        cluster.add_node(num_gpus=0.5)
    assert len(cluster.nodes) == 2


def test_remove_node_frees_its_cards(cluster):
    n2 = cluster.nodes[1]
    cluster.remove_node(n2)
    wait_alive(1)
    assert cluster.free_gpu_ids() == [1, 2]
    assert ray_tpu_torch.cluster_resources()["GPU"] == 1.0
    n3 = cluster.add_node(num_cpus=1, num_gpus=1)
    cluster.wait_for_nodes()
    assert n3.gpu_ids == [1] and cluster.free_gpu_ids() == [2]


def test_kill_and_restart_gcs(cluster):
    """The control plane dies and comes back on its port, replaying its
    tables; the raylets re-register and work runs again."""
    @ray_tpu_torch.remote
    def f(x):
        return x * 3

    assert ray_tpu_torch.get(f.remote(2), timeout=60) == 6
    cluster.kill_gcs()
    assert cluster.gcs_proc is None
    cluster.restart_gcs()
    cluster.wait_for_nodes(timeout=60)
    wait_alive(len(cluster.nodes), timeout=60)
    assert ray_tpu_torch.get(f.remote(7), timeout=60) == 21


def test_a_stage_on_the_card_with_none_raises(cluster):
    """``device=None`` wants a card: leased none (``num_gpus=0``), the
    stage's worker sees no card and raises; nothing falls back to the
    CPU. A fraction of a card raises at once."""
    config = LLMConfig(model="debug", max_len=64)
    process = build_llm_processor(config, batch_size=2, num_gpus=0)
    with pytest.raises((ray_tpu_torch.exceptions.RayTaskError,
                        ray_tpu_torch.exceptions.ActorDiedError), match="CUDA"):
        process(ray_tpu_torch.data.from_items([{"prompt": "a"}, {"prompt": "b"}])).take_all()
    with pytest.raises(ValueError, match="num_gpus=0.5"):
        build_llm_processor(config, num_gpus=0.5)
