"""Graceful drain of a node holding objects and warm leases, on a
multi-node ``Cluster`` of the port's: tests/test_drain.py's
TestGracefulDrain cases of a primary copy pushed to the survivor and warm
leases recalled under a steady task stream, with JAX's assertions, each
with its own n2 (tests/test_torch_cluster_drain.py says how).
"""

import threading
import time

import numpy as np

import ray_tpu_torch
from cluster_ref import drain_cluster, wait_drained, with_n2  # noqa: F401 (fixtures)
from ray_tpu_torch._private.drain import drain_node


def test_primary_objects_pushed_to_survivor(with_n2):
    c, gcs, n2 = with_n2

    @ray_tpu_torch.remote(max_restarts=1, resources={"n2": 0.001})
    class Producer:
        def big(self):
            return np.arange(400_000, dtype=np.float64)  # ~3.2MB

    a = Producer.remote()
    ref = a.big.remote()
    # the value exists on n2, not pulled here (actor results have no
    # lineage: only the drain's push can save this primary copy)
    time.sleep(0.5)
    ray_tpu_torch.wait([ref], num_returns=1, timeout=60, fetch_local=False)
    drain_node(gcs, n2.node_id, deadline_s=15.0)
    wait_drained(gcs, n2.node_id)
    arr = ray_tpu_torch.get(ref, timeout=120)
    assert arr.shape == (400_000,) and float(arr[123]) == 123.0


def test_sustained_load_drain_recalls_warm_leases(with_n2):
    """Under a continuous task stream the warm leases never go idle: the
    recall drains the node far inside its deadline with no error at
    max_retries=0."""
    c, gcs, n2 = with_n2

    @ray_tpu_torch.remote(max_retries=0)
    def f(x):
        time.sleep(0.02)
        return x * 2

    stop = threading.Event()
    errors = []

    def load():
        while not stop.is_set():
            try:
                out = ray_tpu_torch.get([f.remote(i) for i in range(16)], timeout=120)
                assert out == [i * 2 for i in range(16)]
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

    t = threading.Thread(target=load, daemon=True)
    t.start()
    try:
        time.sleep(1.5)  # leases warm on both nodes
        t0 = time.monotonic()
        drain_node(gcs, n2.node_id, deadline_s=20.0)
        info = wait_drained(gcs, n2.node_id, timeout=30)
        dead_s = time.monotonic() - t0
        time.sleep(0.5)
    finally:
        stop.set()
        t.join()
    assert not info["Alive"]
    assert not errors, errors[:3]
    assert dead_s < 15.0, f"recall did not shorten the drain ({dead_s})"
