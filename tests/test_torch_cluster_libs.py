"""Data and Tune under both packages' clusters.

``ray_tpu.init(num_cpus=3)`` and ``ray_tpu_torch.init(num_cpus=3)`` side
by side. Tune's Tuner runs its trials as actors in worker processes in
both (the trainable pickled by each package's cloudpickle, the port's
vendored copy), and the deterministic Tuner cases of
tests/test_torch_tune.py give the same trials. Both packages' Data map
their blocks in worker processes under a cluster: the same rows, and a
test pins where the port's ran.
"""

import os

import numpy as np
import pytest

import ray_tpu
import ray_tpu.data  # noqa: F401
import ray_tpu.tune  # noqa: F401
import ray_tpu_torch
import ray_tpu_torch.data  # noqa: F401
import ray_tpu_torch.tune  # noqa: F401
from test_torch_cluster_cases import (  # noqa: F401
    collect_between_tests, collector_paused, warm_up_workers)
from test_torch_tune import cards_per_trial, trial_error_captured

PACKAGES = (ray_tpu, ray_tpu_torch)


@pytest.fixture(scope="module")
def clusters():
    """Both clusters, with the collector paused while they run
    (test_torch_cluster_cases.py::collector_paused says why)."""
    with collector_paused():
        ray_tpu.init(num_cpus=3, num_tpus=2)
        ray_tpu_torch.init(num_cpus=3, num_gpus=2)
        warm_up_workers()
        yield
        for rt in PACKAGES:
            rt.shutdown()


@pytest.mark.parametrize("fn", [trial_error_captured, cards_per_trial],
                         ids=lambda f: f.__name__)
def test_tuner_trials_as_process_actors(clusters, fn):
    ref, got = (fn(rt) for rt in PACKAGES)
    assert got == ref


def plan(rt, pids):
    def double(block):
        pids.append(os.getpid())
        return {"x": block["id"] * 2}

    rows = (rt.data.range(100, override_num_blocks=4).map_batches(double)
            .filter(lambda r: r["x"] % 3 == 0).random_shuffle(seed=1).take_all())
    sums = (rt.data.from_items([{"k": i % 3, "v": i} for i in range(30)])
            .groupby("k").sum("v").take_all())
    return [{k: np.asarray(v).tolist() for k, v in r.items()} for r in rows], \
        [{k: np.asarray(v).tolist() for k, v in r.items()} for r in sums]


def test_data_plan_runs_in_the_driver(clusters):
    """The plan the driver runs: its map stage in worker processes, in the
    port as in JAX (nothing lands in the driver's list), with the same
    rows; a pid column names the workers'."""
    jax_pids, port_pids = [], []
    assert plan(ray_tpu_torch, port_pids) == plan(ray_tpu, jax_pids)
    assert port_pids == [] and jax_pids == []
    pids = {int(r["pid"]) for r in ray_tpu_torch.data.range(8, override_num_blocks=4)
            .map_batches(lambda b: {"pid": np.full(len(b["id"]), os.getpid())}).take_all()}
    assert pids and os.getpid() not in pids
