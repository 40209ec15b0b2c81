"""tests/test_podracer.py's ``TestSebulbaPreemption`` on the port's
Sebulba, with its invariants: a seeded preemption (the port's
``PreemptionInjector``) takes out one pod actor's node while the stream is
live; training goes on through it; the fleet shrinks by one, the learner
(on the CPU) keeps stepping on the survivor, and nothing surfaces as an
application or order error.
"""

import threading
import time

import ray_tpu_torch as rt
from ray_tpu_torch._private.chaos import PreemptionInjector
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.rllib.podracer import SebulbaConfig


def test_actor_preemption_mid_stream():
    cluster = Cluster()
    cluster.add_node(num_cpus=4)  # head: driver + learner
    cluster.add_node(num_cpus=1, resources={"pod": 1})
    cluster.add_node(num_cpus=1, resources={"pod": 1})
    cluster.wait_for_nodes()
    rt.init(address=cluster.address)
    algo = None
    try:
        cfg = SebulbaConfig(num_actors=2, num_learners=1, rollout_fragment_length=32,
                            updates_per_train=4, seed=0, actor_resources={"pod": 1})
        algo = cfg.build(device="cpu")
        r = algo.train()
        assert sorted(r["live_actors"]) == [0, 1]
        pre_updates = r["num_updates"]

        injector = PreemptionInjector(cluster, seed=7, deadline_s=2.0, jitter_s=0.0)
        done = threading.Event()
        victim = []

        def preempt():
            victim.append(injector.preempt_one())
            done.set()

        t = threading.Thread(target=preempt, daemon=True)
        t.start()
        while not done.is_set():  # keep training THROUGH the preemption
            r = algo.train()
        t.join(timeout=30)
        assert victim and victim[0] is not None
        # let the fleet observe the drain and finish the end-of-stream handoff
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            r = algo.train()
            if len(r["live_actors"]) == 1:
                break
        assert len(r["live_actors"]) == 1  # fleet shrank by one
        assert r["app_errors"] == 0
        assert r["order_errors"] == 0
        assert r["num_updates"] > pre_updates  # kept stepping
    finally:
        if algo is not None:
            algo.stop()
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()
