"""The worker group and the collective API over actors on the port's
cluster, held against the JAX package on the CPU:

- JAX's ``test_fit_multi_worker_actors`` and
  ``test_elastic_scaling_sizes_to_cluster``
  (tests/test_models_train.py:252-290) through ``JaxTrainer`` on JAX's
  cluster and ``TorchTrainer`` on the port's (4 CPUs each), results
  equal;
- ``create_collective_group`` over 2 actors of the port's cluster on
  gloo: every op against numpy (fp32 sums 1e-6; max, min, gather,
  broadcast and send/recv exact), and over an OBJSTORE group of the
  same actors.

The cyclic collector stays paused while JAX's cluster runs
(tests/test_torch_cluster_cases.py's ``collector_paused``), and runs between
tests.
"""


import numpy as np
import pytest

import ray_tpu
import ray_tpu.train as jtrain
import ray_tpu_torch as rt
import torch_ranks
import worker_group_ref as W
from test_torch_cluster_cases import collect_between_tests, collector_paused  # noqa: F401
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.util import collective as col

SEED = 3
PACKAGES = {"jax": (ray_tpu, jtrain, jtrain.JaxTrainer), "port": (rt, ttrain, ttrain.TorchTrainer)}


@pytest.fixture(scope="module")
def clusters():
    with collector_paused():
        ray_tpu.init(num_cpus=4)
        try:
            with W.fake_card_cluster():
                yield
        finally:
            ray_tpu.shutdown()


def multi_worker_loop(train):
    def loop(config):
        ctx = train.get_context()
        train.report({"rank": ctx.get_world_rank(), "world": ctx.get_world_size()})
    return loop


def elastic_loop(train):
    def loop(config):
        ctx = train.get_context()
        train.report({"world": ctx.get_world_size()})
    return loop


@pytest.mark.parametrize("name", list(PACKAGES))
def test_fit_multi_worker_actors(clusters, tmp_path, name):
    _, train, trainer = PACKAGES[name]
    res = trainer(
        multi_worker_loop(train),
        train_loop_config={},
        scaling_config=train.ScalingConfig(num_workers=2),
        run_config=train.RunConfig(name="t4", storage_path=str(tmp_path)),
    ).fit()
    assert res.error is None
    assert res.metrics["world"] == 2 and res.metrics["rank"] == 0


def test_elastic_scaling_sizes_to_cluster(clusters, tmp_path):
    """min_workers set → the group shrinks to what the cluster can host:
    both 4-CPU clusters size 8 workers x 1 CPU to the same group."""
    worlds = {}
    for name, (_, train, trainer) in PACKAGES.items():
        res = trainer(
            elastic_loop(train),
            train_loop_config={},
            scaling_config=train.ScalingConfig(num_workers=8, min_workers=1),
            run_config=train.RunConfig(name="t_elastic", storage_path=str(tmp_path / name)),
        ).fit()
        assert res.error is None
        worlds[name] = res.metrics["world"]
    assert worlds["port"] == worlds["jax"] and 1 <= worlds["port"] <= 4


# ---- create_collective_group over actors -------------------------------------
NP_OPS = {"sum": lambda a: a.sum(0), "product": lambda a: a.prod(0),
          "max": lambda a: a.max(0), "min": lambda a: a.min(0),
          "mean": lambda a: a.mean(0)}


def group_ops(backend, group):
    member = rt.remote(num_cpus=1)(torch_ranks.CollectiveMember)
    actors = [member.remote() for _ in range(W.WORLD)]
    try:
        col.create_collective_group(actors, W.WORLD, list(range(W.WORLD)), backend, group)
        return rt.get([a.ops.remote(group, SEED) for a in actors], timeout=W.GROUP_DEADLINE)
    finally:
        for a in actors:
            rt.kill(a)


def check_group_ops(out, backend):
    x = np.stack([torch_ranks.collective_input(SEED, r) for r in range(W.WORLD)])
    assert len({o["pid"] for o in out}) == W.WORLD
    for r, o in enumerate(out):
        assert (o["rank"], o["world"], o["backend"], o["destroyed"]) == (r, W.WORLD, backend,
                                                                          False)
        for op, f in NP_OPS.items():
            np.testing.assert_allclose(o[("allreduce", op)], f(x), rtol=1e-6, atol=1e-6)
            chunk = len(x[0]) // W.WORLD
            shard = f(x)[r * chunk:(r + 1) * chunk]  # OBJSTORE: np.array_split's
            np.testing.assert_allclose(o[("reducescatter", op)],
                                       shard if backend is None else shard[None], rtol=1e-6,
                                       atol=1e-6)
        np.testing.assert_array_equal(o["allgather"], x)
        np.testing.assert_array_equal(o["broadcast"], x[-1])
        np.testing.assert_array_equal(o["recv"], x[(r - 1) % W.WORLD][(r - 1) % W.WORLD])


def test_create_collective_group_over_actors(clusters):
    check_group_ops(group_ops("gloo", "g"), "gloo")


def test_create_collective_group_objstore_over_actors(clusters):
    """The same ops over an OBJSTORE group of the same actors: no process
    group in any of them, numpy out, the same values (fp32 sums 1e-6;
    max, min, gather, broadcast and send/recv exact)."""
    check_group_ops(group_ops("objstore", "g_objstore"), None)
