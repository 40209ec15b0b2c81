"""Preemption on port clusters, with the JAX package's assertions:
tests/test_chaos.py's ``TestPreemptionSoak`` through the port's
``PreemptionInjector`` (a two-node cluster under mixed task and actor load
survives one seeded, deadline-jittered preemption with zero
application-visible errors; the tier-1 smoke at JAX's own scale, 40 tasks,
10 actor calls and a 6 s deadline; the soak stays ``slow`` as JAX's is),
and tests/test_drain.py's ``test_slice_preemption_drains_whole_slice``
(preempting one slice member drains every host sharing its ``slice_id``).
"""

import time

import pytest

import ray_tpu_torch
from cluster_ref import wait_drained
from ray_tpu_torch._private.chaos import PreemptionInjector
from ray_tpu_torch._private.drain import (
    EVENT_DRAIN_COMPLETE,
    EVENT_DRAIN_START,
    REASON_PREEMPTION,
    drain_node,
)
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import state as rstate
from ray_tpu_torch.util.scheduling_strategies import NodeAffinitySchedulingStrategy


def _preemption_soak(n_tasks: int, n_actor_calls: int, deadline_s: float,
                     task_sleep_s: float = 0.05) -> None:
    """Core of the preemption soak: a 2-node cluster under mixed
    task+actor load survives one seeded, deadline-jittered preemption
    with ZERO application-visible errors — every task and actor call
    succeeds, the actor restarts elsewhere, and the drain shows up on
    the event bus."""
    cluster = Cluster()
    cluster.add_node(num_cpus=2)
    n2 = cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    try:
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote(max_retries=3)
        def work(x):
            import time as _t

            _t.sleep(task_sleep_s)
            return x * 2

        @ray_tpu_torch.remote(max_restarts=3)
        class Stateful:
            def bump(self, x):
                return x + 1

        actor = Stateful.options(
            scheduling_strategy=NodeAffinitySchedulingStrategy(
                n2.node_id, soft=True)).remote()
        assert ray_tpu_torch.get(actor.bump.remote(0), timeout=120) == 1

        injector = PreemptionInjector(
            cluster, interval_s=1.0, max_preemptions=1, seed=42,
            deadline_s=deadline_s, jitter_s=deadline_s / 4)
        errors = []
        results = {"tasks": 0, "actor_calls": 0}
        injector.start()
        try:
            # interleave task waves with actor calls, and KEEP the load
            # up until the preemption has fired and completed — the soak
            # is about surviving the drain, not finishing before it
            wave = max(4, n_tasks // 10)
            hard_stop = time.monotonic() + 180
            while (results["tasks"] < n_tasks
                   or results["actor_calls"] < n_actor_calls
                   or not injector.preempted) and \
                    time.monotonic() < hard_stop:
                refs = [work.remote(i) for i in range(wave)]
                acalls = [actor.bump.remote(j) for j in range(2)]
                try:
                    vals = ray_tpu_torch.get(refs, timeout=240)
                    assert vals == [i * 2 for i in range(len(refs))]
                    results["tasks"] += len(refs)
                except Exception as e:  # noqa: BLE001
                    errors.append(("task", repr(e)))
                    results["tasks"] += len(refs)
                for j, r in enumerate(acalls):
                    try:
                        assert ray_tpu_torch.get(r, timeout=240) == j + 1
                        results["actor_calls"] += 1
                    except Exception as e:  # noqa: BLE001
                        errors.append(("actor", repr(e)))
                        results["actor_calls"] += 1
        finally:
            injector.stop()
        assert injector.preempted, "chaos never fired"
        assert not errors, f"application-visible errors: {errors[:5]}"
        types = [e["type"] for e in rstate.list_events()]
        assert EVENT_DRAIN_START in types
        assert EVENT_DRAIN_COMPLETE in types
        # the actor survived the preemption (restarted if it was hit)
        assert ray_tpu_torch.get(actor.bump.remote(10), timeout=120) == 11
        info = rstate.get_actor(actor._actor_id.hex())
        assert info["state"] == "ALIVE"
    finally:
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass  # teardown is best-effort: chaos may have killed the cluster
        cluster.shutdown()


def test_preemption_under_load_smoke():
    """Tier-1 variant: small mixed load, one preemption."""
    _preemption_soak(n_tasks=40, n_actor_calls=10, deadline_s=6.0)


@pytest.mark.stress
@pytest.mark.slow
def test_preemption_under_load_soak():
    """Full soak: heavier load, longer drain window."""
    _preemption_soak(n_tasks=200, n_actor_calls=60, deadline_s=12.0,
                     task_sleep_s=0.1)


def test_slice_preemption_drains_whole_slice():
    """Preempting one slice member drains every host sharing its
    slice_id label (the slice is one failure domain)."""
    cluster = Cluster()
    cluster.add_node(num_cpus=2)
    m1 = cluster.add_node(num_cpus=1, labels={"slice_id": "s0"})
    m2 = cluster.add_node(num_cpus=1, labels={"slice_id": "s0"})
    other = cluster.add_node(num_cpus=1, labels={"slice_id": "s1"})
    cluster.wait_for_nodes()
    gcs = RpcClient("127.0.0.1", cluster.gcs_port)
    try:
        rep = drain_node(gcs, m1.node_id, reason=REASON_PREEMPTION,
                         deadline_s=5.0)
        assert set(rep["draining"]) == {m1.node_id, m2.node_id}
        for n in (m1, m2):
            wait_drained(gcs, n.node_id)
        alive = {i["NodeID"] for i in gcs.call("GetAllNodeInfo", timeout=10) if i["Alive"]}
        assert other.node_id in alive  # another slice is untouched
    finally:
        gcs.close()
        cluster.shutdown()
