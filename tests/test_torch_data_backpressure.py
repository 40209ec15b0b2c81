"""Object-store-pressure backpressure of the port's streaming executor
(reference: backpressure_policy/ + the resource manager's store budget):
tests/test_data_backpressure.py's assertions on a ``Cluster`` whose node
has a 64 MB store. A pipeline of 256 MB, made by map tasks in the
workers, completes, and the store's allocation stays within its capacity
while the driver iterates; the executor saw the store above its
watermark and held submissions back."""

import numpy as np
import pytest

import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401
from cluster_ref import port_cluster
from ray_tpu_torch.data._internal import streaming_executor

CAP = 64 * 1024 * 1024


@pytest.fixture(scope="module")
def small_store():
    with port_cluster({"num_cpus": 4, "object_store_memory": CAP}) as c:
        yield c


def test_streaming_bounded_memory_small_store(small_store, monkeypatch):
    from ray_tpu_torch._private import worker as wm

    plasma = wm.global_worker.core.plasma
    # what the executor's watermark check answered on each tick
    seen = []
    real = streaming_executor._store_pressure
    monkeypatch.setattr(streaming_executor, "_store_pressure",
                        lambda: seen.append(real()) or seen[-1])
    # 32 blocks x ~8MB = 256MB through a 64MB store
    ds = ray_tpu_torch.data.range(32 * 1_000_000 // 1000, override_num_blocks=32) \
        .map_batches(lambda b: {"x": np.repeat(b["id"].astype(np.float64), 1000)})
    peak = 0
    rows = 0
    total = 0.0
    for blk in ds.iter_blocks():
        rows += len(blk["x"])
        total += float(blk["x"].sum())
        m = plasma.metrics()
        peak = max(peak, m["allocated"])
        del blk
    assert rows == 32 * 1000 * 1000
    assert total == 1000.0 * float(np.arange(32_000).sum())
    assert peak <= CAP, f"allocated {peak} exceeded capacity {CAP}"
    assert m["capacity"] == CAP
    assert any(seen), "the store never passed the watermark: nothing was held back"
