"""Tune over the port's cluster, continued from
tests/test_torch_tune_cluster.py: tests/test_tune.py::TestTpeSearcher::test_tpe_in_tuner's
14 trials one at a time on a two-node ``Cluster``, identical to JAX's in
JAX's local mode.
"""

import pytest

import ray_tpu_torch
from cluster_ref import port_cluster
from test_torch_tune import tpe_in_tuner
from test_torch_tune_cluster import jax_local


@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 2}, {"num_cpus": 4}) as c:
        yield c


def test_tpe_in_tuner(cluster):
    assert tpe_in_tuner(ray_tpu_torch) == jax_local(tpe_in_tuner)
