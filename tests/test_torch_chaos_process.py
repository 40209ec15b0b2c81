"""Process chaos on port clusters, tests/test_chaos.py's
``TestProcessChaos`` with its assertions: a workload survives workers
SIGKILLed by the port's ``WorkerKiller`` (found through ``/proc``) and a
node removed by its ``NodeKiller``, every retriable task returning its
value.
"""

import time

import ray_tpu_torch
from ray_tpu_torch._private.chaos import NodeKiller, WorkerKiller
from ray_tpu_torch.cluster_utils import Cluster


def test_workload_survives_worker_kills():
    cluster = Cluster()
    cluster.add_node(num_cpus=4)
    cluster.wait_for_nodes()
    try:
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote(max_retries=5)
        def slow(x):
            import time as _t

            _t.sleep(0.3)
            return x + 1

        killer = WorkerKiller(cluster, interval_s=0.7, max_kills=3)
        futs = [slow.remote(i) for i in range(24)]
        killer.start()
        try:
            out = ray_tpu_torch.get(futs, timeout=240)
        finally:
            killer.stop()
        assert out == [i + 1 for i in range(24)]
        assert killer.kills >= 1  # chaos actually happened
    finally:
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass  # teardown is best-effort: chaos may have killed the cluster
        cluster.shutdown()


def test_workload_survives_node_kill():
    cluster = Cluster()
    cluster.add_node(num_cpus=2)
    cluster.add_node(num_cpus=2)
    cluster.wait_for_nodes()
    try:
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote(max_retries=5)
        def slow(x):
            import time as _t

            _t.sleep(0.25)
            return x * 10

        futs = [slow.remote(i) for i in range(16)]
        time.sleep(0.8)  # let work spread onto the worker node
        killer = NodeKiller(cluster, max_kills=1)
        killed = killer.kill_one()
        assert killed is not None
        out = ray_tpu_torch.get(futs, timeout=240)
        assert out == [i * 10 for i in range(16)]
    finally:
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass  # teardown is best-effort: chaos may have killed the cluster
        cluster.shutdown()
