"""What the port's GCS reports to the autoscaler (``GetClusterDemand``),
on a port ``Cluster`` under ``RAY_TPU_FAKE_GPUS=1``, for a card actor's
lifecycle: while its lease is granted and its ``__init__`` runs it is no
demand (it holds the card already: counting it would launch a node for
nothing); once its node dies and its restart waits with no card anywhere,
it is demand (or a lost card node is never replaced). And a node whose
first lease waits for its worker to start is not idle meanwhile (or an
autoscaler terminates the node it launched for that lease). The JAX
package's GCS counts PENDING actors alone, creation included
(``ray_tpu/_private/gcs/server.py:724-730``), and its raylet reports no
lease while a worker starts (ROADMAP Queue C).
"""

import os
import time

import ray_tpu_torch as rt
from cluster_ref import FAST_DEATH, gcs_client, port_cluster
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy

HEARTBEAT = dict(FAST_DEATH, RAY_TPU_FAKE_GPUS="1")  # 100 ms beats, a death seen in 2 s
CARD_ACTOR = {"CPU": 1.0, "GPU": 1.0}


class SlowInit:
    def __init__(self, marker):
        open(marker, "w").close()
        time.sleep(3.0)

    def ping(self):
        return os.getpid()


def test_card_actor_demand_through_creation_and_restart(tmp_path):
    marker = str(tmp_path / "in_init")
    with port_cluster({"num_cpus": 2}, {"num_cpus": 1, "num_gpus": 1},
                      env=HEARTBEAT) as cluster:
        gcs = gcs_client(cluster)
        try:
            actor = rt.remote(num_gpus=1, max_restarts=1)(SlowInit).remote(marker)
            ready = actor.ping.remote()
            seen = []
            while not rt.wait([ready], timeout=0)[0]:
                if os.path.exists(marker):  # the lease is granted, __init__ runs
                    seen.append(gcs.call("GetClusterDemand", timeout=10)["pending_actors"])
                time.sleep(0.05)
            assert len(seen) > 10 and seen == [[]] * len(seen)
            rt.get(ready, timeout=60)
            cluster.remove_node(cluster.nodes[1])  # the card's node dies
            deadline = time.monotonic() + 30
            while gcs.call("GetClusterDemand", timeout=10)["pending_actors"] != [CARD_ACTOR]:
                assert time.monotonic() < deadline, "the restart never became demand"
                time.sleep(0.1)
        finally:
            gcs.close()


def test_a_node_starting_its_first_worker_is_not_idle():
    with port_cluster({"num_cpus": 1}, {"num_cpus": 1}, env=HEARTBEAT) as cluster:
        gcs = gcs_client(cluster)
        fresh = cluster.nodes[1]

        def idle_s():
            return next(n["idle_s"] for n in gcs.call("GetClusterDemand", timeout=10)["nodes"]
                        if n["node_id"] == fresh.node_id)

        try:
            deadline = time.monotonic() + 10
            while idle_s() < 0.5:  # idle before anything lands there
                assert time.monotonic() < deadline
                time.sleep(0.05)
            ref = rt.remote(lambda: time.sleep(0.5) or os.getpid()).options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    fresh.node_id, soft=False)).remote()
            time.sleep(0.5)  # a few heartbeats: the grant is reported
            samples = []
            while not rt.wait([ref], timeout=0)[0]:
                samples.append(idle_s())
                time.sleep(0.05)
            rt.get(ref, timeout=60)
            # the worker's start (its node's zygote boots first) spans many
            # samples, and in none of them is the node idle
            assert len(samples) > 10 and max(samples) == 0.0, samples
        finally:
            gcs.close()
