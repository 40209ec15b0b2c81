"""Tune over the port's cluster, continued from
tests/test_torch_tune_cluster.py: tests/test_tune.py::TestTuner::test_pbt_exploits_bad_trials
with JAX's assertions on a two-node ``Cluster`` (_tune_tpe.py has
TestTpeSearcher::test_tpe_in_tuner). The trials run 20 steps of 0.25 s
(JAX's: 40 of 0.4 s, sized for trials that take seconds to launch;
tests/test_torch_tune.py's local-mode run: 20 of 0.1 s): the workers are
warm before the Tuner
starts, so the three trial actors start within a few hundred ms of each
other and the controller's 50 ms poll sees the bottom trial's iterations
5, 10 and 15 while it runs. A trial whose actor lease queued on a node
that had no free CPU used to wait there past the Tuner's 30 s start
timeout, though the other node had room (the raylet spilled a queued lease
back only when it was infeasible; ROADMAP.md Queue C), and the trials then
no longer overlapped: this case failed so in 2 of 12 runs with that
spillback taken out of the raylet.
"""

import json
import os
import time

import pytest

import ray_tpu_torch
import ray_tpu_torch.tune  # noqa: F401
from cluster_ref import port_cluster


@pytest.fixture(scope="module")
def cluster():
    with port_cluster({"num_cpus": 2}, {"num_cpus": 4}) as c:
        yield c


def test_pbt_exploits_bad_trials(cluster, tmp_path):
    tune = ray_tpu_torch.tune

    def trainable(config):
        step, score = 0, 0.0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.as_directory(), "state.json")) as f:
                st = json.load(f)
            step, score = st["step"], st["score"]
        for i in range(step + 1, 21):
            score += config["lr"]
            d = os.path.join(config["storage"], f"{os.getpid()}_{i}_{time.monotonic_ns()}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": i, "score": score}, f)
            tune.report({"score": score, "training_iteration": i},
                        checkpoint=tune.Checkpoint(d))
            time.sleep(0.25)

    @ray_tpu_torch.remote
    def warm():
        time.sleep(0.3)

    ray_tpu_torch.get([warm.options(scheduling_strategy="SPREAD").remote() for _ in range(6)],
                      timeout=120)
    pbt = tune.PopulationBasedTraining(metric="score", mode="max", perturbation_interval=5,
                                       hyperparam_mutations={"lr": [0.01, 1.0]}, seed=0)
    grid = tune.Tuner(trainable,
                      param_space={"lr": tune.grid_search([0.01, 1.0, 1.0]),
                                   "storage": str(tmp_path)},
                      tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=pbt,
                                                  max_concurrent_trials=3)).fit()
    assert pbt.num_perturbations >= 1
    assert sorted(r.metrics.get("score", 0.0) for r in grid)[-1] > 5.0  # a good trial ran
    assert [r for r in grid if r.restart_ckpt]  # one restarted from a donor
