"""Tune over the port's cluster: tests/test_tune.py's TestTuner cluster
cases (best result, a failing trial, ASHA over concurrent trials,
Train-in-Tune), with trials as actors in the workers of a two-node
``Cluster``, held against JAX's Tuner on the same cases in JAX's local
mode (collector paused; no JAX cluster): identical trials where the
outcome is deterministic, JAX's assertion where it depends on timing.
tests/test_torch_tune_pbt.py has the PBT case, _tune_tpe.py the TPE case.
"""

import pytest

import ray_tpu
import ray_tpu_torch
from cluster_ref import collector_paused, port_cluster
from test_torch_tune import (
    asha_stops_bad_trials,
    fit_selects_best,
    run_local,
    train_in_tune,
    trial_error_captured,
)


@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 2}, {"num_cpus": 4}) as c:
        yield c


def jax_local(fn, *args):
    """The case in JAX's local mode, the collector paused."""
    with collector_paused():
        return run_local(ray_tpu, fn, *args)


@pytest.mark.parametrize("fn", [fit_selects_best, trial_error_captured],
                         ids=lambda f: f.__name__)
def test_tuner_same_outcome_as_ray_tpu(cluster, fn):
    assert fn(ray_tpu_torch) == jax_local(fn)


def test_asha_stops_bad_trials(cluster):
    assert asha_stops_bad_trials(ray_tpu_torch) == 4


def test_train_in_tune(cluster, tmp_path):
    assert train_in_tune(ray_tpu_torch, str(tmp_path / "port")) == \
        jax_local(train_in_tune, str(tmp_path / "jax"))
