"""RPC chaos on port clusters, tests/test_chaos.py's ``TestRpcChaos``
with its assertions: the cluster makes progress under dropped lease
requests, dropped heartbeat replies and injected latency (the spec is set
in the port's config before ``init()``, and its daemons inherit it).
Killed workers and nodes are tests/test_torch_chaos_process.py's, the
raylet's OOM killer tests/test_torch_chaos_oom.py's.
"""

import pytest

import ray_tpu_torch
from ray_tpu_torch._private.config import config


@pytest.fixture
def chaos_cluster():
    """Single-node cluster whose daemons inherit the chaos spec set in
    config BEFORE the fixture runs (propagates via RAY_TPU_CONFIG_JSON)."""
    yield
    config.testing_rpc_failure = ""
    try:
        ray_tpu_torch.shutdown()
    except Exception:
        pass  # teardown is best-effort: chaos may have killed the cluster


def _run_workload(n=30, retries=3):
    @ray_tpu_torch.remote(max_retries=retries)
    def f(x):
        return x * x

    return ray_tpu_torch.get([f.remote(i) for i in range(n)], timeout=240)


# (spec, tasks): a dropped lease request is retried; heartbeat replies lost
# 20% of the time leave the raylet working (the reference's Response
# kind); GetObject held 200 ms half the time
RPC_CHAOS = {
    "dropped_lease_requests_retry": ("RequestWorkerLease=0.3", 30),
    "dropped_replies_are_survivable": ("Heartbeat=0.2:response", 20),
    "injected_latency": ("GetObject=0.5:delay:200", 10),
}


@pytest.mark.parametrize("case", sorted(RPC_CHAOS))
def test_rpc_chaos(case, chaos_cluster):
    spec, n = RPC_CHAOS[case]
    config.testing_rpc_failure = spec
    ray_tpu_torch.init(num_cpus=4)
    assert _run_workload(n) == [i * i for i in range(n)]
