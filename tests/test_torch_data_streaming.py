"""Data over worker processes: the shuffle and streaming cases of
tests/test_data_streaming.py and tests/test_data.py::TestClusterExec on a
two-node ``Cluster`` of the port's, each outcome held against JAX's Data
on the same seeds (tests/test_torch_data_files.py has the file cases and
the stages' overlap, which reads parquet).

JAX's side runs in JAX's local mode in this process, with the collector
paused (tests/test_torch_cluster_cases.py::collector_paused says why), so
no JAX cluster starts; its rows do not depend on where blocks were mapped.
The port's plan runs on the streaming executor: its map stages and
shuffles as tasks in the cluster's workers, which the pids of the map
show.
"""

import os

import numpy as np

import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401
from cluster_ref import both, data_cluster as cluster  # noqa: F401


def ids_of(ds):
    return np.concatenate([b["id"] for b in ds.iter_blocks()])


def test_distributed_sort(cluster):
    ref, got = both(lambda D: ids_of(D.range(10_000, override_num_blocks=8)
                                     .random_shuffle(seed=7).sort("id").materialize()))
    assert (got == np.arange(10_000)).all() and (got == ref).all()


def test_distributed_sort_descending(cluster):
    ref, got = both(lambda D: ids_of(D.range(5_000, override_num_blocks=4)
                                     .sort("id", descending=True)))
    assert (got == np.arange(4_999, -1, -1)).all() and (got == ref).all()


def test_distributed_shuffle_is_permutation(cluster):
    ref, got = both(lambda D: ids_of(D.range(8_000, override_num_blocks=4)
                                     .random_shuffle(seed=3)))
    assert len(got) == 8_000
    assert not (got == np.arange(8_000)).all()  # actually shuffled
    assert (np.sort(got) == np.arange(8_000)).all()  # a permutation
    assert (got == ref).all()  # JAX's order, row for row


def test_distributed_groupby(cluster):
    def counts(D):
        ds = D.range(1_000, override_num_blocks=5).add_column("bucket", lambda b: b["id"] % 10)
        return sorted((int(r["bucket"]), int(r["count()"]))
                      for r in ds.groupby("bucket").count().materialize().take_all())

    ref, got = both(counts)
    assert len(got) == 10 and all(c == 100 for _, c in got)
    assert got == ref


def test_repartition_distributed(cluster):
    ref, got = both(lambda D: [b["id"].tolist() for b in
                               D.range(1_024, override_num_blocks=2).repartition(8).iter_blocks()])
    assert len(got) == 8 and sum(len(b) for b in got) == 1_024
    assert got == ref


def test_map_batches_over_tasks(cluster):
    """TestClusterExec's case, and where the map ran: in worker
    processes of the cluster, none of them the driver."""
    ref, got = both(lambda D: D.range(1000, override_num_blocks=8).map_batches(
        lambda b: {"id": b["id"] * 3}).sum("id"))
    assert got == 3 * sum(range(1000)) and got == ref
    pids = ray_tpu_torch.data.range(1000, override_num_blocks=8).map_batches(
        lambda b: {"pid": np.full(len(b["id"]), os.getpid())}).take_all()
    pids = {int(r["pid"]) for r in pids}
    assert pids and os.getpid() not in pids
