"""The autoscaler on a port ``Cluster``: tests/test_autoscaler.py's
``TestEndToEnd::test_scale_up_then_down`` with JAX's assertions (demand
the head cannot serve launches a real raylet through ``LocalNodeProvider``,
the tasks run there, and the idle node is terminated). The provider's card
ownership is tests/test_torch_autoscaler_cards.py's.
"""

import time

import ray_tpu_torch
from ray_tpu_torch.autoscaler import Autoscaler, LocalNodeProvider, NodeTypeConfig
from ray_tpu_torch.cluster_utils import Cluster


def test_scale_up_then_down():
    """Real flow: demand the head can't serve → autoscaler launches a
    real raylet → tasks run there → idle node is terminated."""
    cluster = Cluster()
    cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes()
    provider = LocalNodeProvider(cluster.gcs_addr)
    asc = Autoscaler(
        cluster.gcs_addr,
        {"cpu2": NodeTypeConfig(resources={"CPU": 2.0}, max_workers=2)},
        provider, idle_timeout_s=6.0, interval_s=1.0,
    )
    try:
        ray_tpu_torch.init(address=cluster.address)

        @ray_tpu_torch.remote(num_cpus=2)
        def big(x):
            return x * 10

        futs = [big.remote(i) for i in range(3)]
        asc.start()
        out = ray_tpu_torch.get(futs, timeout=180)
        assert out == [0, 10, 20]
        assert asc.num_launches >= 1
        # scale-down: every launched node ends up idle-terminated
        # (nodes pass the idle threshold on different reconcile rounds)
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline and \
                provider.non_terminated_nodes():
            time.sleep(1.0)
        assert asc.num_terminations >= 1
        assert provider.non_terminated_nodes() == {}
    finally:
        asc.stop()
        try:
            ray_tpu_torch.shutdown()
        except Exception:
            pass  # teardown is best-effort: cluster may already be down
        provider.shutdown()
        cluster.shutdown()
