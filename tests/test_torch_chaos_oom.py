"""tests/test_chaos.py's ``TestOomWorkerKilling`` on a port ``Cluster``:
under host-memory pressure (a percentage read from a file the test
writes) the raylet kills a worker from the biggest owner group — youngest
first — and the retriable task resubmits. JAX's ``TestFakeChipBackend``
has its counterpart in ``RAY_TPU_FAKE_GPUS``, held by
tests/test_torch_autoscaler_cards.py and the cluster card tests.
"""

import os
import time

import ray_tpu_torch
from ray_tpu_torch._private.config import config as _cfg
from ray_tpu_torch._private.rpc import RpcClient
from ray_tpu_torch.cluster_utils import Cluster


def test_pressure_kills_and_task_retries(tmp_path):
    pct_file = tmp_path / "mem_pct"
    pct_file.write_text("10")
    os.environ["RAY_TPU_TESTING_MEMORY_PCT_FILE"] = str(pct_file)
    os.environ["RAY_TPU_MEMORY_USAGE_THRESHOLD"] = "0.9"
    os.environ["RAY_TPU_MEMORY_MONITOR_PERIOD_S"] = "0.2"
    _cfg.initialize()
    cluster = Cluster()
    cluster.add_node(num_cpus=4)
    cluster.wait_for_nodes()
    try:
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote(max_retries=3)
        def slow(i):
            import time as _t

            _t.sleep(3.0)
            return i

        refs = [slow.remote(i) for i in range(3)]
        time.sleep(1.5)  # workers leased and running
        pct_file.write_text("99")  # breach the 90% threshold
        # wait for at least one OOM kill to land
        raylet = RpcClient("127.0.0.1", cluster.nodes[0].raylet_port)
        deadline = time.monotonic() + 30
        kills = 0
        while time.monotonic() < deadline:
            kills = raylet.call("GetState", timeout=10)["num_oom_kills"]
            if kills >= 1:
                break
            time.sleep(0.3)
        raylet.close()
        assert kills >= 1, "memory pressure did not kill any worker"
        pct_file.write_text("10")  # pressure clears
        # the killed worker's task retried and the workload completes
        assert sorted(ray_tpu_torch.get(refs, timeout=180)) == [0, 1, 2]
    finally:
        for k in ("RAY_TPU_TESTING_MEMORY_PCT_FILE",
                  "RAY_TPU_MEMORY_USAGE_THRESHOLD",
                  "RAY_TPU_MEMORY_MONITOR_PERIOD_S"):
            os.environ.pop(k, None)
        _cfg.initialize()
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass  # teardown is best-effort: chaos may have killed the cluster
        cluster.shutdown()
