"""The port's Tune (ray_tpu_torch.tune) against ray_tpu.tune, in local mode.

The cases of tests/test_tune.py run through both packages, each under its
own ``init(local_mode=True)``. What is deterministic must be identical:
``generate_variants`` for a seed, every scheduler's decisions on the same
report sequence, ``TpeSearcher``'s suggestions, and a Tuner's trial
configs, metrics, histories and errors under ``max_concurrent_trials=1``.
Where the outcome depends on thread timing (ASHA's asynchronous rungs
and PBT's exploits over concurrent trials), each package must meet the
assertion of tests/test_tune.py. Train-in-Tune runs ``JaxTrainer`` in
JAX's trial and ``TorchTrainer`` in the port's.
"""

import json
import os
import random
import time

import pytest

import ray_tpu
import ray_tpu.train  # noqa: F401 — rt.train in the cases
import ray_tpu.tune  # noqa: F401
import ray_tpu_torch
import ray_tpu_torch.train  # noqa: F401
import ray_tpu_torch.tune  # noqa: F401
from ray_tpu.tune.search import generate_variants as jax_variants
from ray_tpu_torch.tune.search import generate_variants as port_variants

PACKAGES = (ray_tpu, ray_tpu_torch)


def run_local(rt, fn, *args):
    rt.init(local_mode=True)
    try:
        return fn(rt, *args)
    finally:
        rt.shutdown()


def both(fn, *args):
    """fn(rt, *args) through each package in local mode: (JAX's, the port's)."""
    return tuple(run_local(rt, fn, *args) for rt in PACKAGES)


def trials(grid):
    """A ResultGrid's trials as plain data, errors by their last line."""
    return [(r.trial_id, r.config, r.metrics, r.history,
             r.error.strip().splitlines()[-1] if r.error else None) for r in grid]


# ---- search spaces ---------------------------------------------------------
def space(tune):
    return {"lr": tune.loguniform(1e-5, 1e-1), "wd": tune.uniform(0.0, 0.3),
            "bs": tune.choice([16, 32]), "layers": tune.randint(1, 5),
            "q": tune.quniform(16, 128, 16), "a": tune.grid_search([1, 2, 3]),
            "b": tune.grid_search([10, 20]), "const": "x"}


@pytest.mark.parametrize("seed", [0, 7, None])
def test_generate_variants_identical(seed):
    ref = jax_variants(space(ray_tpu.tune), num_samples=3, seed=seed)
    got = port_variants(space(ray_tpu_torch.tune), num_samples=3, seed=seed)
    assert len(got) == len(ref) == 18
    assert {(v["a"], v["b"]) for v in got} == {(a, b) for a in (1, 2, 3) for b in (10, 20)}
    if seed is not None:
        assert got == ref
    for tune, variants in ((ray_tpu.tune, jax_variants), (ray_tpu_torch.tune, port_variants)):
        sampled = variants({"lr": tune.loguniform(1e-5, 1e-1), "bs": tune.choice([16, 32]),
                            "layers": tune.randint(1, 5)}, num_samples=20, seed=0)
        assert all(1e-5 <= v["lr"] <= 1e-1 and v["bs"] in (16, 32) and 1 <= v["layers"] < 5
                   for v in sampled)
        assert len(variants({"a": tune.grid_search([1, 2]), "x": tune.uniform(0, 1)},
                            num_samples=3)) == 6


# ---- schedulers on the same report sequences -------------------------------
def reports(seed, n_trials=8, steps=12):
    """Interleaved (trial, result) reports: losses that fall at per-trial
    rates, some with noise, in a seeded arrival order."""
    rng = random.Random(seed)
    base = {f"t{i}": rng.uniform(0.5, 5.0) for i in range(n_trials)}
    rate = {t: rng.uniform(0.0, 0.3) for t in base}
    step = {t: 0 for t in base}
    out = []
    while any(s < steps for s in step.values()):
        t = rng.choice([t for t, s in step.items() if s < steps])
        step[t] += 1
        out.append((t, {"loss": base[t] - rate[t] * step[t] + rng.gauss(0, 0.05),
                        "training_iteration": step[t]}))
    return out


def decisions(sched, seq, register=False):
    out = []
    for tid, res in seq:
        if register and hasattr(sched, "register"):
            sched.register(tid, {"lr": 0.1})
        d = sched.on_result(tid, res)
        if d == "EXPLOIT":
            out.append((tid, d, sched.exploit_info(tid)))
        else:
            out.append((tid, d))
    return out


SCHEDULERS = {
    "asha": lambda tune: tune.ASHAScheduler(metric="loss", mode="min", max_t=10,
                                            grace_period=1, reduction_factor=2),
    "asha_max": lambda tune: tune.ASHAScheduler(metric="loss", mode="max", max_t=20,
                                                grace_period=2, reduction_factor=3),
    "hyperband": lambda tune: tune.HyperBandScheduler(metric="loss", mode="min", max_t=9,
                                                      reduction_factor=3),
    "median": lambda tune: tune.MedianStoppingRule(metric="loss", mode="min",
                                                   grace_period=2),
    "pbt": lambda tune: tune.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=3, seed=5,
        hyperparam_mutations={"lr": [0.001, 0.01, 0.1, 1.0],
                              "wd": tune.uniform(0.0, 0.1)}),
    "fifo": lambda tune: tune.FIFOScheduler(),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_identical(name):
    for seed in (0, 1, 2):
        seq = reports(seed)
        ref = decisions(SCHEDULERS[name](ray_tpu.tune), seq, register=True)
        got = decisions(SCHEDULERS[name](ray_tpu_torch.tune), seq, register=True)
        assert got == ref
        if name not in ("fifo",):
            assert {d[1] for d in got} != {"CONTINUE"}, name  # the sequence reaches a decision


@pytest.mark.parametrize("rt", PACKAGES, ids=["ray_tpu", "ray_tpu_torch"])
def test_pbt_decision_logic(rt):
    from importlib import import_module

    S = import_module(f"{rt.__name__}.tune.schedulers")
    pbt = rt.tune.PopulationBasedTraining(
        metric="m", mode="max", perturbation_interval=2,
        hyperparam_mutations={"lr": [0.1, 1.0]}, seed=0)
    pbt.register("a", {"lr": 1.0})
    pbt.register("b", {"lr": 0.1})
    assert pbt.on_result("a", {"m": 10, "training_iteration": 2}) == S.CONTINUE
    assert pbt.on_result("b", {"m": 1, "training_iteration": 2}) == S.EXPLOIT
    donor, cfg = pbt.exploit_info("b")
    assert donor == "a" and "lr" in cfg


@pytest.mark.parametrize("rt", PACKAGES, ids=["ray_tpu", "ray_tpu_torch"])
def test_hyperband_brackets_stop_laggards(rt):
    hb = rt.tune.HyperBandScheduler(metric="loss", mode="min", max_t=9, reduction_factor=3)
    assert len({b.grace for b in hb._brackets}) > 1
    out = []
    for tid, loss in [("t0", 0.1), ("t1", 0.2), ("t2", 0.3), ("t3", 9.0)]:
        hb._assignment[tid] = 1
        out.append(hb.on_result(tid, {"loss": loss, "training_iteration": 3}))
    assert out[-1] == "STOP" and out[0] == "CONTINUE"


# ---- TPE -------------------------------------------------------------------
def tpe_run(tune, seed, steps=30):
    s = tune.TpeSearcher(n_startup_trials=8, seed=seed)
    s.set_search_properties("loss", "min", {
        "x": tune.uniform(-2.0, 2.0), "lr": tune.loguniform(1e-5, 1e-1),
        "layers": tune.randint(1, 5), "act": tune.choice(["relu", "gelu", "tanh"]),
        "batch": tune.quniform(16, 128, 16), "const": 7})
    out = []
    for i in range(steps):
        cfg = s.suggest(f"t{i}")
        loss = (cfg["x"] - 0.7) ** 2 + abs(cfg["layers"] - 3) + (cfg["act"] == "tanh")
        s.on_trial_complete(f"t{i}", {"loss": loss})
        out.append(cfg)
    return out


@pytest.mark.parametrize("seed", [0, 3])
def test_tpe_suggestions_identical(seed):
    assert tpe_run(ray_tpu_torch.tune, seed) == tpe_run(ray_tpu.tune, seed)


def tpe_best(tune, budget=60):
    """tests/test_tune.py's TPE-vs-random comparison: TPE's best losses."""
    out = []
    for seed in (0, 1, 2):
        s = tune.TpeSearcher(n_startup_trials=10, seed=seed)
        s.set_search_properties("loss", "min",
                                {"x": tune.uniform(-2.0, 2.0), "y": tune.uniform(-2.0, 2.0)})
        best = float("inf")
        for i in range(budget):
            cfg = s.suggest(f"t{i}")
            loss = (cfg["x"] - 0.7) ** 2 + (cfg["y"] + 0.3) ** 2
            s.on_trial_complete(f"t{i}", {"loss": loss})
            best = min(best, loss)
        out.append(best)
    return out


def test_tpe_beats_random_identically():
    ref, got = tpe_best(ray_tpu.tune), tpe_best(ray_tpu_torch.tune)
    assert got == ref and min(got) < 0.02


@pytest.mark.parametrize("rt", PACKAGES, ids=["ray_tpu", "ray_tpu_torch"])
def test_tpe_domains(rt):
    tune = rt.tune
    s = tune.TpeSearcher(n_startup_trials=2, seed=0, max_trials=8)
    s.set_search_properties("loss", "min", {
        "lr": tune.loguniform(1e-5, 1e-1), "layers": tune.randint(1, 5),
        "act": tune.choice(["relu", "gelu"]), "batch": tune.quniform(16, 128, 16),
        "const": 7})
    seen = 0
    for i in range(20):
        cfg = s.suggest(f"t{i}")
        if cfg is None:
            break
        seen += 1
        assert 1e-5 <= cfg["lr"] <= 1e-1 and cfg["layers"] in (1, 2, 3, 4)
        assert cfg["act"] in ("relu", "gelu") and cfg["const"] == 7
        assert cfg["batch"] % 16 == 0 and 16 <= cfg["batch"] <= 128
        s.on_trial_complete(f"t{i}", {"loss": float(i)})
    assert seen == 8
    with pytest.raises(ValueError, match="grid_search"):
        tune.TpeSearcher().set_search_properties("loss", "min", {"a": tune.grid_search([1])})


# ---- Tuner.fit -------------------------------------------------------------
def fit_selects_best(rt):
    tune = rt.tune

    def objective(config):
        tune.report({"score": (config["x"] - 3) ** 2, "training_iteration": 1})

    grid = tune.Tuner(objective, param_space={"x": tune.grid_search([0, 1, 2, 3, 4])},
                      tune_config=tune.TuneConfig(metric="score", mode="min",
                                                  max_concurrent_trials=1)).fit()
    best = grid.get_best_result()
    assert len(grid) == 5 and best.config["x"] == 3 and best.metrics["score"] == 0
    frame = grid.get_dataframe().to_dict("list")
    return trials(grid), best.trial_id, frame, grid.errors


def trial_error_captured(rt):
    tune = rt.tune

    def objective(config):
        if config["x"] == 1:
            raise RuntimeError("bad trial")
        for i in range(1, 3):
            tune.report({"score": config["x"] * i, "training_iteration": i})

    grid = tune.Tuner(objective, param_space={"x": tune.grid_search([0, 1, 2])},
                      tune_config=tune.TuneConfig(metric="score", mode="max",
                                                  max_concurrent_trials=1)).fit()
    assert len(grid.errors) == 1 and grid.get_best_result().config["x"] == 2
    with pytest.raises(ValueError, match="No successful trial"):
        grid.get_best_result(metric="missing")
    return trials(grid), grid.get_best_result(mode="min").trial_id


def asha_sequential(rt):
    """ASHA over trials run one at a time: its stops are deterministic."""
    tune = rt.tune

    def objective(config):
        for i in range(1, 9):
            tune.report({"loss": config["base"] - i * 0.01, "training_iteration": i})

    sched = tune.ASHAScheduler(metric="loss", mode="min", max_t=8, grace_period=1,
                               reduction_factor=2)
    grid = tune.Tuner(objective,
                      param_space={"base": tune.grid_search([0.5, 3.0, 1.0, 5.0, 0.2])},
                      tune_config=tune.TuneConfig(metric="loss", mode="min",
                                                  scheduler=sched,
                                                  max_concurrent_trials=1)).fit()
    return [(r.config["base"], len(r.history), r.metrics) for r in grid]


def tpe_in_tuner(rt):
    tune = rt.tune

    def objective(config):
        tune.report({"loss": (config["x"] - 0.5) ** 2, "training_iteration": 1})

    grid = tune.Tuner(objective, param_space={"x": tune.uniform(-2.0, 2.0)},
                      tune_config=tune.TuneConfig(
                          metric="loss", mode="min", num_samples=14,
                          max_concurrent_trials=1,
                          search_alg=tune.TpeSearcher(n_startup_trials=4, seed=3))).fit()
    assert len(grid) == 14 and grid.get_best_result().metrics["loss"] < 0.3
    budget = tune.Tuner(objective, param_space={"x": tune.uniform(-2.0, 2.0)},
                        tune_config=tune.TuneConfig(
                            metric="loss", num_samples=3, max_concurrent_trials=1,
                            search_alg=tune.TpeSearcher(seed=0, max_trials=2))).fit()
    return trials(grid), trials(budget)


def cards_per_trial(rt):
    """A trial that asks for one accelerator: "GPU" in the port, "TPU" in
    JAX (the actor's num_gpus / num_tpus)."""
    tune = rt.tune
    key = "GPU" if rt is ray_tpu_torch else "TPU"

    def objective(config):
        tune.report({"score": config["x"], "training_iteration": 1})

    grid = tune.Tuner(objective, param_space={"x": tune.grid_search([1, 2])},
                      tune_config=tune.TuneConfig(metric="score", max_concurrent_trials=1),
                      resources_per_trial={key: 1}).fit()
    return trials(grid)


@pytest.mark.parametrize("fn", [fit_selects_best, trial_error_captured, asha_sequential,
                                tpe_in_tuner, cards_per_trial],
                         ids=lambda f: f.__name__)
def test_tuner_same_outcome_as_ray_tpu(fn):
    ref, got = both(fn)
    assert got == ref


def asha_stops_bad_trials(rt):
    """tests/test_tune.py's ASHA case: 4 concurrent trials."""
    tune = rt.tune

    def objective(config):
        for i in range(1, 20):
            tune.report({"loss": config["base"] - i * config["slope"], "training_iteration": i})
            time.sleep(0.04 if config["base"] < 1 else 0.15)

    sched = tune.ASHAScheduler(metric="loss", mode="min", max_t=20, grace_period=2,
                               reduction_factor=2)
    grid = tune.Tuner(objective,
                      param_space={"base": tune.grid_search([0.5, 0.5, 10.0, 10.0]),
                                   "slope": 0.02},
                      tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=sched,
                                                  max_concurrent_trials=4)).fit()
    assert grid.get_best_result().config["base"] == 0.5
    bad = [r for r in grid if r.config["base"] == 10.0]
    assert any(len(r.history) < 19 for r in bad)
    return len(grid)


def pbt_exploits_bad_trials(rt, storage):
    """tests/test_tune.py's PBT case: 20 steps of 0.1 s, not 40 of 0.4 s
    (trials start in ms in local mode, so the controller polls mid-run).
    The controller reads every report; an exploit needs its poll (every
    50 ms) to see the bottom trial's iteration 5, 10 or 15 before that
    trial ends, 1.5, 1.0 or 0.5 s later."""
    tune = rt.tune

    def trainable(config):
        step, score = 0, 0.0
        ckpt = tune.get_checkpoint()
        if ckpt is not None:
            with open(os.path.join(ckpt.as_directory(), "state.json")) as f:
                st = json.load(f)
            step, score = st["step"], st["score"]
        for i in range(step + 1, 21):
            score += config["lr"]
            d = os.path.join(config["storage"], f"{config['lr']}_{i}_{time.monotonic_ns()}")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, "state.json"), "w") as f:
                json.dump({"step": i, "score": score}, f)
            tune.report({"score": score, "training_iteration": i},
                        checkpoint=tune.Checkpoint(d))
            time.sleep(0.1)

    pbt = tune.PopulationBasedTraining(metric="score", mode="max", perturbation_interval=5,
                                       hyperparam_mutations={"lr": [0.01, 1.0]}, seed=0)
    grid = tune.Tuner(trainable,
                      param_space={"lr": tune.grid_search([0.01, 1.0, 1.0]),
                                   "storage": storage},
                      tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=pbt,
                                                  max_concurrent_trials=3)).fit()
    assert pbt.num_perturbations >= 1
    assert sorted(r.metrics.get("score", 0.0) for r in grid)[-1] > 5.0
    assert [r for r in grid if r.restart_ckpt]
    return len(grid)


def test_asha_and_pbt_meet_jax_assertions(tmp_path):
    assert both(asha_stops_bad_trials) == (4, 4)
    for rt in PACKAGES:
        storage = tmp_path / rt.__name__
        storage.mkdir()
        assert run_local(rt, pbt_exploits_bad_trials, str(storage)) == 3


def train_in_tune(rt, storage):
    tune, train = rt.tune, rt.train
    Trainer = train.TorchTrainer if rt is ray_tpu_torch else train.JaxTrainer

    def trial(config):
        def loop(cfg):
            for step in range(2):
                train.report({"loss": 1.0 / (1 + cfg["lr"]) + step, "step": step})

        res = Trainer(loop, train_loop_config={"lr": config["lr"]},
                      run_config=train.RunConfig(name=f"inner_{config['lr']}",
                                                 storage_path=storage)).fit()
        tune.report({"loss": res.metrics["loss"], "training_iteration": 1})

    grid = tune.Tuner(trial, param_space={"lr": tune.grid_search([0.1, 1.0])},
                      tune_config=tune.TuneConfig(metric="loss", mode="min",
                                                  max_concurrent_trials=1)).fit()
    assert grid.get_best_result().config["lr"] == 1.0
    return trials(grid)


def test_train_in_tune(tmp_path):
    ref = run_local(ray_tpu, train_in_tune, str(tmp_path / "jax"))
    got = run_local(ray_tpu_torch, train_in_tune, str(tmp_path / "port"))
    assert got == ref
