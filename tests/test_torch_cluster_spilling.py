"""Object spilling and create backpressure on the port's store:
tests/test_spilling.py's two cases, with JAX's assertions, on a one-node
``Cluster`` whose node has a 64 MB store (JAX's fixture's). Workloads of
twice the store complete, restored from disk on read, in the driver and in
workers.
"""

import time

import numpy as np
import pytest

import ray_tpu_torch
from cluster_ref import port_cluster

STORE = 64 * 1024 * 1024


@pytest.fixture(scope="module")
def small_store_cluster():
    with port_cluster({"num_cpus": 2, "object_store_memory": STORE}) as c:
        yield c


def test_put_twice_store_capacity_and_read_back(small_store_cluster):
    n_obj, n_elem = 16, 1_000_000  # 16 x 8 MB = 128 MB = 2x capacity
    refs = [ray_tpu_torch.put(np.full(n_elem, float(i))) for i in range(n_obj)]
    # everything readable back (early objects restored from disk)
    t0 = time.monotonic()
    for i, r in enumerate(refs):
        arr = ray_tpu_torch.get(r, timeout=120)
        assert arr[0] == float(i) and arr.shape == (n_elem,)
    # no stall: the JAX package's raylet keeps each restored object from
    # spilling for 10 s, so the 9th read waited ~10 s for room (ROADMAP.md
    # Queue C); the port's lets a consumed one go after 0.5 s
    assert time.monotonic() - t0 < 8.0
    # spill actually happened
    from ray_tpu_torch._private import worker as worker_mod

    state = worker_mod.global_worker.core.raylet.call("GetState", timeout=10)
    assert state["spilled_bytes_total"] > 0


def test_task_outputs_spill_and_serve(small_store_cluster):
    @ray_tpu_torch.remote
    def produce(i):
        return np.full(1_000_000, float(i))  # 8 MB each

    @ray_tpu_torch.remote
    def total(arr):
        return float(arr[0])

    refs = [produce.remote(i) for i in range(16)]  # 2x capacity
    ray_tpu_torch.wait(refs, num_returns=len(refs), timeout=180)
    # consume them all through tasks (worker-side restore path)
    vals = ray_tpu_torch.get([total.remote(r) for r in refs], timeout=180)
    assert vals == [float(i) for i in range(16)]
