"""A seeded preemption mid sustained allreduce on the port's OBJSTORE
group, tests/test_collective_elastic.py's ``TestDrainElasticity``
invariants at tier-1 scale: a three-node ``Cluster`` (head + two workers,
two ranks pinned to each worker) loops allreduces while the port's
``PreemptionInjector`` drains one worker and kills it. Every sum any rank
returns is one a pinned membership could produce (the full set, the
survivors, or the survivors with one victim not yet removed): never a sum
over a membership that never existed. The survivors then complete a
degraded sum exactly, at a bumped epoch over the survivor ranks, and the
drain is on the event bus.
"""

import threading
import time
import types

import numpy as np

import ray_tpu_torch as rt
from objstore_ref import Member, teardown
from ray_tpu_torch._private.chaos import PreemptionInjector
from ray_tpu_torch._private.drain import EVENT_DRAIN_START
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.exceptions import GetTimeoutError
from ray_tpu_torch.util import state as rstate
from ray_tpu_torch.util.collective import CollectiveError, CollectiveRankFailure
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy


def test_preemption_mid_sustained_allreduce():
    cluster = Cluster()
    cluster.add_node(num_cpus=2)  # head: driver + rendezvous
    workers = [cluster.add_node(num_cpus=2), cluster.add_node(num_cpus=2)]
    cluster.wait_for_nodes()
    try:
        rt.init(address=cluster.address)
        gname = "elastic_drain"
        node_of = [workers[0], workers[0], workers[1], workers[1]]
        keys = ["nodeA", "nodeA", "nodeB", "nodeB"]
        ws = [Member.options(scheduling_strategy=NodeAffinitySchedulingStrategy(
            node_of[r].node_id, soft=False)).remote(
                r, 4, gname, {"RAY_TPU_COLLECTIVE_TOPOLOGY_KEY": keys[r],
                              "RAY_TPU_COLLECTIVE_OP_TIMEOUT_S": "10"})
            for r in range(4)]
        parts = [np.full((64 << 10,), float(r + 1), np.float32) for r in range(4)]
        full = np.sum(np.stack(parts), axis=0)
        for o in rt.get([w.allreduce.remote(p) for w, p in zip(ws, parts)], timeout=120):
            np.testing.assert_array_equal(o, full)

        # the rendezvous actor must outlive the preemption, so the victim
        # is the worker node NOT hosting it
        rdv = rt.get_actor(f"__collective_rdv_{gname}")
        rdv_node = (rstate.get_actor(rdv._actor_id.hex()) or {}).get("node_id")
        victim = workers[0] if workers[1].node_id == rdv_node else workers[1]
        victim_ranks = [r for r in range(4) if node_of[r] is victim]
        surv_ranks = [r for r in range(4) if r not in victim_ranks]
        plausible = [full]
        for extra in ([], *[[v] for v in victim_ranks]):
            ranks = sorted(surv_ranks + extra)
            plausible.append(np.sum(np.stack([parts[r] for r in ranks]), axis=0))
        surv_sum = np.sum(np.stack([parts[r] for r in surv_ranks]), axis=0)

        injector = PreemptionInjector(
            types.SimpleNamespace(nodes=[victim], gcs_port=cluster.gcs_port),
            max_preemptions=1, seed=17, deadline_s=4.0, jitter_s=1.0, kill_grace_s=2.0)
        killer = threading.Thread(target=injector.preempt_one, daemon=True)
        killer.start()
        live = dict(enumerate(ws))
        rounds = recovered_at = 0
        hard_stop = time.monotonic() + 120
        while time.monotonic() < hard_stop and not recovered_at:
            futs = {r: live[r].allreduce.remote(parts[r]) for r in sorted(live)}
            round_ok = {}
            for r, f in futs.items():
                try:
                    round_ok[r] = rt.get(f, timeout=45)
                except Exception as e:  # noqa: BLE001
                    assert not isinstance(e, GetTimeoutError), \
                        "allreduce hung past its deadline budget"
                    if isinstance(e, CollectiveRankFailure) and r in e.dead_ranks:
                        live.pop(r, None)  # told it left the group: retire it
                    elif not isinstance(e, CollectiveError):
                        live.pop(r, None)  # actor/node death
            rounds += 1
            for v in round_ok.values():
                assert any(np.array_equal(v, p) for p in plausible), \
                    "silent wrong result under drain"
            if injector.preempted and sorted(round_ok) == surv_ranks and \
                    all(np.array_equal(round_ok[r], surv_sum) for r in surv_ranks):
                recovered_at = time.monotonic()
        killer.join(timeout=15)
        assert injector.preempted == [victim.node_id], "preemption never fired"
        assert recovered_at, "survivors never recovered a degraded allreduce"
        assert rounds > 1  # the loop ran through the drain
        assert EVENT_DRAIN_START in [e["type"] for e in rstate.list_events()]
        for v in rt.get([ws[r].view.remote() for r in surv_ranks], timeout=30):
            assert v["epoch"] >= 1 and v["members"] == surv_ranks
        teardown([ws[r] for r in surv_ranks])
    finally:
        try:
            rt.shutdown()
        except Exception:  # noqa: BLE001
            pass
        cluster.shutdown()
