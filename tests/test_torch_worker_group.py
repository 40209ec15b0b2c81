"""The port's worker group (ray_tpu_torch.train: TorchTrainer with
``num_workers`` above 1, elastic sizing) held against the JAX package on
the CPU.

- ``decide_num_workers`` of both packages over one table of
  (num_workers, min_workers, per-worker resources, cluster totals), with
  each package's ``cluster_resources`` patched to the same totals ("GPU"
  for the port where JAX has "TPU"), the failed query included.
- A group of 2 ``TrainWorker`` actors on 2 fake cards
  (``RAY_TPU_FAKE_GPUS=2``): each leases its own card, the workers join
  one gloo process group (``bootstrap.group_backend``) and run 2 steps of
  ``debug`` (fp32) at ``MeshSpec(data=2)`` from JAX's init
  (``state_from_jax``), held against JAX's step at data=2 on the CPU mesh
  (tests/sharded_step_ref.py's tolerances: 2e-5 on metrics, 5e-5 on
  grads) and against the single-device grads.

A retry of such a group is tests/test_torch_worker_group_retry.py's; JAX's
own trainer cases through both packages and ``create_collective_group``
over actors are tests/test_torch_worker_group_actors.py's (files split to
keep each under 20 s). The loops run in the cluster's workers
(tests/torch_ranks.py); each group's fit has ``GROUP_DEADLINE`` seconds.
"""

import os

import pytest

import sharded_step_ref as R
import torch_ranks
import worker_group_ref as W
from ray_tpu.train import scaling_policy as jsp
from ray_tpu.train.config import ScalingConfig as JScalingConfig
from ray_tpu_torch import train as ttrain
from ray_tpu_torch.train import scaling_policy as tsp


# ---- elastic sizing: one table, both packages --------------------------------
FAILED = None  # the cluster resource query raises
SIZING = [  # (num_workers, min_workers, accel per worker, cpus per worker, extra, totals)
    (5, None, None, 1.0, None, {"CPU": 1.0}),
    (8, 1, None, 1.0, None, {"CPU": 4.0}),
    (8, 2, 1, 1.0, None, {"CPU": 16.0, "ACC": 4.0}),
    (8, 6, 1, 1.0, None, {"CPU": 16.0, "ACC": 4.0}),
    (4, 1, 2, 1.0, None, {"CPU": 8.0, "ACC": 3.0}),
    (3, 1, None, 2.0, None, {"CPU": 5.0}),
    (4, 1, 1, 1.0, None, {"CPU": 8.0}),
    (2, 5, None, 1.0, None, {"CPU": 8.0}),
    (6, 1, None, 1.0, {"custom": 2.0}, {"CPU": 8.0, "custom": 5.0}),
    (6, 2, 1, 1.0, None, FAILED),
]


class _Clock:
    """The scaling policy's ``time`` module, its sleeps recorded."""

    def __init__(self):
        self.slept = []

    def sleep(self, s):
        self.slept.append(s)


@pytest.mark.parametrize("row", SIZING, ids=[str(i) for i in range(len(SIZING))])
def test_decide_num_workers_matches_jax(monkeypatch, row):
    n, lo, acc, cpus, extra, totals = row
    sides = {}
    for name, mod, pkg, key in (("jax", jsp, "ray_tpu", "TPU"), ("port", tsp, "ray_tpu_torch", "GPU")):
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        if totals is FAILED:
            def query():
                raise ConnectionError("GCS unreachable")
        else:
            def query(key=key):
                return {(key if k == "ACC" else k): v for k, v in totals.items()}
        monkeypatch.setattr(__import__(pkg), "cluster_resources", query)
        kw = dict(num_workers=n, min_workers=lo, num_cpus_per_worker=cpus,
                  resources_per_worker=dict(extra) if extra else None)
        sc = (JScalingConfig(use_tpu=acc is not None, chips_per_worker=acc, **kw) if name == "jax"
              else ttrain.ScalingConfig(use_gpu=acc is not None, gpus_per_worker=acc, **kw))
        sides[name] = (mod.decide_num_workers(sc), clock.slept)
    assert sides["port"] == sides["jax"]


def test_decide_num_workers_sizes_gpu_workers_by_card():
    """A use_gpu worker takes one card when gpus_per_worker is unset."""
    assert ttrain.ScalingConfig(use_gpu=True).worker_resources() == {"CPU": 1.0, "GPU": 1}
    assert ttrain.ScalingConfig(use_gpu=True, gpus_per_worker=0).worker_resources() == {"CPU": 1.0}
    assert ttrain.ScalingConfig().worker_resources() == {"CPU": 1.0}


# ---- the group on the port's cluster ----------------------------------------
@pytest.fixture(scope="module")
def cluster():
    with W.fake_card_cluster():
        yield


@pytest.fixture(scope="module")
def reference():
    return W.reference()


@pytest.fixture(scope="module")
def group(cluster, reference, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("group"))
    case = dict(preset="debug", overrides={}, spec={"data": W.WORLD}, state=reference["state"],
                tokens=reference["tokens"], steps=W.STEPS)
    res = W.fit(ttrain.TorchTrainer(
        torch_ranks.group_train, train_loop_config={"case": case, "out": out},
        scaling_config=ttrain.ScalingConfig(num_workers=W.WORLD, use_gpu=True),
        run_config=ttrain.RunConfig(name="group", storage_path=os.path.join(out, "store"))))
    return res, [W.load(out, f"rank{r}") for r in range(W.WORLD)]


def test_group_workers_lease_distinct_cards_and_join_gloo(group):
    res, ranks = group
    assert res.error is None
    seen = [r["seen"] for r in ranks]
    assert [(s["rank"], s["world"], s["dist"]) for s in seen] == \
        [(r, W.WORLD, (r, W.WORLD)) for r in range(W.WORLD)]
    assert {s["backend"] for s in seen} == {"gloo"}
    assert sorted(s["visible"] for s in seen) == ["0", "1"]
    assert all(s["jax_imported"] == [] for s in seen)
    assert res.metrics == {"loss": ranks[0]["metrics"][-1]["loss"], "rank": 0}


def test_group_steps_match_jax_data2(group, reference):
    _, ranks = group
    R.check_metrics(ranks, reference["jax"]["metrics"])
    R.check_params(ranks, reference["jax"]["params"], R.whole, steps=W.STEPS)


def test_group_grads_match_single_device(group, reference):
    _, ranks = group
    R.check_grads(ranks, reference["jax"]["single"], R.whole)
