"""The port's trainer (ray_tpu_torch.train: TorchTrainer, session,
config, scaling policy) held against the JAX package's JaxTrainer on the
CPU: every case of tests/test_models_train.py::TestJaxTrainer that runs
in process, through both trainers, with the same results; and a loop
that saves its train state every step (save_state) and fails once,
whose resumed losses equal an uninterrupted fit's bit for bit.

``debug`` in fp32; both loops start from JAX's init (the port's through
state_from_jax) on the same tokens. Losses within 2e-5 of JAX's
(tests/test_ops.py's fp32 tolerance). Elastic sizing against JAX's on
the same cluster totals, and a worker group of several ``TrainWorker``
actors in the port's local mode; the groups on the port's cluster (a
process group across worker processes) are
tests/test_torch_worker_group*.py's.
"""

import contextlib
import os
import weakref

import numpy as np
import pytest
import torch

import ray_tpu.train as jtrain
import sharded_step_ref as R
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import session as jsession
from ray_tpu.train import step as JS
from ray_tpu.train.config import ScalingConfig as JScalingConfig
from ray_tpu.train.scaling_policy import decide_num_workers as jdecide
import ray_tpu_torch.train as ttrain
from ray_tpu_torch import train as S
from ray_tpu_torch.models.convert import state_from_jax
from ray_tpu_torch.train import session as tsession
from ray_tpu_torch.train.scaling_policy import decide_num_workers as tdecide

ATOL = 2e-5
LR = 1e-2  # TestJaxTrainer.test_fit_in_process's
STEPS = 3
TRAINERS = {"jax": (jtrain, jtrain.JaxTrainer), "port": (ttrain, ttrain.TorchTrainer)}


@pytest.fixture(scope="module")
def model():
    """JAX's config, optimizer and init (8-device data mesh, as the JAX
    test's loop), the port's config and the same init as numpy, tokens."""
    jcfg, tcfg = R.configs("debug")
    jopt = JS.default_optimizer(jcfg, lr=LR)
    mesh = build_mesh(MeshSpec(data=-1))
    jstate = JS.init_state(jcfg, jopt, mesh)
    return {"jcfg": jcfg, "tcfg": tcfg, "jopt": jopt, "mesh": mesh, "jstate": jstate,
            "state0": R.np_state(jstate), "tokens": R.tokens(jcfg.vocab_size)}


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms on one thread, so two port runs compare
    bit for bit: else the CPU's embedding backward sums in a varying
    order, and a BLAS may split its sums by the machine's load
    (tests/test_torch_mesh.py)."""
    was, threads = torch.are_deterministic_algorithms_enabled(), torch.get_num_threads()
    torch.use_deterministic_algorithms(True)
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        torch.set_num_threads(threads)


def _port_step(model):
    opt = S.default_optimizer(model["tcfg"], lr=LR)
    return S.make_train_step(model["tcfg"], opt, device="cpu")


@pytest.fixture(scope="module")
def fits(model, tmp_path_factory):
    """TestJaxTrainer.test_fit_in_process through both trainers: each
    loop's losses and the Result."""
    root = tmp_path_factory.mktemp("fit")
    batch = {"tokens": model["tokens"]}
    losses = {"jax": [], "port": []}

    def jax_loop(config):
        ts = JS.make_train_step(model["jcfg"], model["jopt"], model["mesh"], donate=False)
        state = model["jstate"]
        for i in range(config["steps"]):
            state, m = ts(state, batch)
            losses["jax"].append(float(m["loss"]))
            jtrain.report({"loss": float(m["loss"]), "step": i})

    def port_loop(config):
        state = state_from_jax(model["state0"], model["tcfg"], device="cpu")
        run = _port_step(model)
        for i in range(config["steps"]):
            state, m = run(state, batch)
            losses["port"].append(float(m["loss"]))
            ttrain.report({"loss": float(m["loss"]), "step": i})

    results = {}
    for name, loop in (("jax", jax_loop), ("port", port_loop)):
        mod, trainer = TRAINERS[name]
        with deterministic():
            results[name] = trainer(
                loop, train_loop_config={"steps": STEPS},
                run_config=mod.RunConfig(name="t0", storage_path=str(root / name))).fit()
    return {"losses": losses, "results": results}


def test_fit_in_process(fits):
    for res in fits["results"].values():
        assert res.error is None
        assert res.metrics["step"] == STEPS - 1
    np.testing.assert_allclose(fits["losses"]["port"], fits["losses"]["jax"], atol=ATOL)
    assert fits["losses"]["port"][-1] < fits["losses"]["port"][0]


def _resume_case(mod, trainer, tmp_path):
    """TestJaxTrainer.test_fit_with_checkpoint_and_resume's loop."""
    def loop(config):
        ctx = mod.get_context()
        start = 0
        ck = ctx.get_checkpoint()
        if ck:
            start = ck.get_metadata()["metrics"]["step"] + 1
        for i in range(start, start + 2):
            d = os.path.join(str(tmp_path), f"w{i}")
            os.makedirs(d, exist_ok=True)
            c = mod.Checkpoint(d)
            c.update_metadata({"metrics": {"step": i}})
            mod.report({"step": i}, checkpoint=c)

    rc = mod.RunConfig(name="t1", storage_path=str(tmp_path / "store"))
    r1 = trainer(loop, train_loop_config={}, run_config=rc).fit()
    r2 = trainer(loop, train_loop_config={}, run_config=rc).fit()
    return {"r1": r1.metrics, "r2": r2.metrics,
            "checkpoint": os.path.relpath(r2.checkpoint.path, r2.path),
            "checkpoint_metrics": r2.checkpoint.get_metadata()["metrics"],
            "listing": sorted(os.listdir(r2.path))}


def test_fit_with_checkpoint_and_resume(tmp_path):
    out = {name: _resume_case(mod, trainer, tmp_path / name)
           for name, (mod, trainer) in TRAINERS.items()}
    assert out["port"] == out["jax"]
    assert out["port"]["r1"]["step"] == 1 and out["port"]["r2"]["step"] == 3


def _retry_case(mod, trainer, tmp_path, max_failures):
    marker = tmp_path / "fail_once"
    calls = []

    def loop(config):
        calls.append(1)
        if not marker.exists():
            marker.write_text("x")
            raise RuntimeError("preempted")
        mod.report({"ok": 1})

    rc = mod.RunConfig(name="t2", storage_path=str(tmp_path / "store2"),
                       failure_config=mod.FailureConfig(max_failures=max_failures))
    res = trainer(loop, train_loop_config={}, run_config=rc).fit()
    return {"metrics": res.metrics, "error": None if res.error is None else
            ("preempted" in str(res.error), type(res.error).__name__), "calls": len(calls)}


@pytest.mark.parametrize("max_failures", [1, -1, 0])
def test_failure_retry(tmp_path, max_failures):
    """1 and -1 (for ever) retry once from the latest checkpoint; 0 fails
    fast with the formatted traceback as a RuntimeError."""
    out = {name: _retry_case(mod, trainer, tmp_path / name, max_failures)
           for name, (mod, trainer) in TRAINERS.items()}
    assert out["port"] == out["jax"]
    if max_failures:
        assert out["port"] == {"metrics": {"ok": 1}, "error": None, "calls": 2}
    else:
        assert out["port"] == {"metrics": {}, "error": (True, "RuntimeError"), "calls": 1}


def test_failure_exhausted(tmp_path):
    out = {}
    for name, (mod, trainer) in TRAINERS.items():
        def loop(config):
            raise RuntimeError("boom")

        rc = mod.RunConfig(name="t3", storage_path=str(tmp_path / name / "store3"),
                           failure_config=mod.FailureConfig(max_failures=2))
        res = trainer(loop, train_loop_config={}, run_config=rc).fit()
        out[name] = (res.error is not None, "boom" in str(res.error), res.metrics,
                     res.checkpoint)
    assert out["port"] == out["jax"] == (True, True, {}, None)


def test_keep_one_through_fit(tmp_path):
    out = {}
    for name, (mod, trainer) in TRAINERS.items():
        root = tmp_path / name

        def loop(config):
            for i in range(3):
                d = root / f"report{i}"
                d.mkdir(parents=True)
                (d / "x.txt").write_text(str(i))
                mod.report({"step": i}, checkpoint=mod.Checkpoint(str(d)))

        rc = mod.RunConfig(name="k1", storage_path=str(root / "store"),
                           checkpoint_config=mod.CheckpointConfig(num_to_keep=1))
        res = trainer(loop, train_loop_config={}, run_config=rc).fit()
        out[name] = (sorted(os.listdir(res.path)), os.path.basename(res.checkpoint.path),
                     (root / "store" / "checkpoint_000002" / "x.txt").read_text(),
                     res.checkpoint.get_metadata()["metrics"])
    assert out["port"] == out["jax"]
    assert out["port"][0] == [".ckpt_index.json", "checkpoint_000002"]


def test_state_checkpoint_every_step_resumes_bit_for_bit(model, fits, tmp_path):
    """The loop restores its train state from the latest checkpoint when
    there is one, saves it after every step (save_state into the
    reported checkpoint) and fails once after reporting step 1: the
    losses of steps 0-2 equal the uninterrupted fit's bit for bit (both
    under ``deterministic``; so JAX's within 2e-5), and the failed
    attempt's state is freed before the retry starts."""
    marker = tmp_path / "fail_once"
    losses, alive = [], []
    batch = {"tokens": model["tokens"]}

    def loop():
        ck = ttrain.get_checkpoint()
        if ck is None:
            state = state_from_jax(model["state0"], model["tcfg"], device="cpu")
        else:
            state = ttrain.restore_state(os.path.join(ck.path, "state"), device="cpu")
        alive.append(weakref.ref(state["params"]["embed"]))
        if ck is not None:  # the first attempt's state is gone
            alive.append(alive[0]() is None)
        run = _port_step(model)
        for i in range(int(state["step"]), STEPS):
            state, m = run(state, batch)
            losses.append(float(m["loss"]))
            d = tmp_path / "reports" / f"step{i}"
            ttrain.save_state(state, str(d / "state"))
            ttrain.report({"loss": losses[-1], "step": i}, checkpoint=ttrain.Checkpoint(str(d)))
            if i == 1 and not marker.exists():
                marker.write_text("x")
                raise RuntimeError("preempted after step 1")

    rc = ttrain.RunConfig(name="s", storage_path=str(tmp_path / "store"),
                          failure_config=ttrain.FailureConfig(max_failures=1),
                          checkpoint_config=ttrain.CheckpointConfig(num_to_keep=1))
    with deterministic():
        res = ttrain.TorchTrainer(loop, run_config=rc).fit()
    assert res.error is None and res.metrics["step"] == STEPS - 1
    assert alive[2] is True  # checked at the second attempt's start
    assert losses == fits["losses"]["port"]
    np.testing.assert_allclose(losses, fits["losses"]["jax"], atol=ATOL)
    assert sorted(os.listdir(res.path)) == [".ckpt_index.json", "checkpoint_000002"]
    last = ttrain.restore_state(os.path.join(res.checkpoint.path, "state"), device="cpu")
    assert int(last["step"]) == STEPS and int(last["opt_state"]["count"]) == STEPS


def test_decide_num_workers(monkeypatch):
    """tests/test_models_train.py::test_elastic_decision_function's
    configs; the elastic one sized against the same 3-CPU totals."""
    fixed = (JScalingConfig(num_workers=5), ttrain.ScalingConfig(num_workers=5))
    assert not fixed[1].elastic and jdecide(fixed[0]) == tdecide(fixed[1]) == 5
    el = ttrain.ScalingConfig(num_workers=5, min_workers=2)
    jel = JScalingConfig(num_workers=5, min_workers=2)
    assert el.elastic and jel.elastic
    import ray_tpu
    import ray_tpu_torch

    for pkg in (ray_tpu, ray_tpu_torch):
        monkeypatch.setattr(pkg, "cluster_resources", lambda: {"CPU": 3.0})
    assert jdecide(jel) == tdecide(el) == 3


@pytest.fixture
def local_mode():
    import ray_tpu_torch

    ray_tpu_torch.init(local_mode=True)
    yield ray_tpu_torch.cluster_resources()
    ray_tpu_torch.shutdown()


@pytest.mark.parametrize("scaling", [{"num_workers": 2}, {"num_workers": 8, "min_workers": 1}])
def test_worker_groups_run_in_local_mode(tmp_path, local_mode, scaling):
    """A group of several runs its loop in TrainWorker actors (threads in
    local mode; no process group without use_gpu, as JAX's CPU workers),
    each with its rank; an elastic group sized to the node's CPUs."""
    seen = []

    def loop(config):
        ctx = ttrain.get_context()
        seen.append((ctx.get_world_rank(), ctx.get_world_size()))
        ttrain.report({"rank": ctx.get_world_rank(), "world": ctx.get_world_size()})

    res = ttrain.TorchTrainer(
        loop, train_loop_config={},
        scaling_config=ttrain.ScalingConfig(**scaling),
        run_config=ttrain.RunConfig(name="t4", storage_path=str(tmp_path))).fit()
    n = min(8, int(local_mode["CPU"])) if "min_workers" in scaling else 2
    assert res.error is None and res.metrics == {"rank": 0, "world": n}
    assert sorted(seen) == [(r, n) for r in range(n)]


def test_scaling_config_names_the_card():
    sc = ttrain.ScalingConfig(use_gpu=True, gpus_per_worker=2, num_cpus_per_worker=4)
    jsc = JScalingConfig(use_tpu=True, chips_per_worker=2, num_cpus_per_worker=4)
    assert sc.worker_resources() == {"CPU": 4, "GPU": 2}
    assert jsc.worker_resources() == {"CPU": 4, "TPU": 2}
    assert sc.mesh == ttrain.ScalingConfig().mesh and sc.mesh.data == -1
    with pytest.raises(ValueError, match="TPU slice"):
        ttrain.ScalingConfig(topology="v5e-64")


def test_scaling_config_num_slices():
    """JAX's field: one slice is the default and builds; more raise the
    bootstrap's NotImplementedError, naming its ROADMAP row."""
    assert ttrain.ScalingConfig().num_slices == JScalingConfig().num_slices == 1
    assert ttrain.ScalingConfig(num_slices=1, num_workers=2).num_workers == 2
    assert JScalingConfig(num_slices=2).num_slices == 2
    with pytest.raises(NotImplementedError, match="multi-slice megascale_env"):
        ttrain.ScalingConfig(num_slices=2)


@pytest.mark.parametrize("name", list(TRAINERS))
def test_outer_session_restored_after_nested_fit(tmp_path, name):
    mod, trainer = TRAINERS[name]
    sess = {"jax": jsession, "port": tsession}[name]
    outer = sess.TrainContext(world_rank=3, world_size=4, experiment_name="outer")
    sess._set_session(outer)
    try:
        seen = []

        def loop(config):
            ctx = mod.get_context()
            seen.append((ctx.get_world_rank(), ctx.get_world_size(),
                         ctx.get_experiment_name(), ctx.get_storage_path()))
            mod.report({"rank": ctx.get_world_rank(), "world": ctx.get_world_size()})

        res = trainer(loop, train_loop_config={},
                      run_config=mod.RunConfig(name="inner", storage_path=str(tmp_path))).fit()
        assert mod.get_context() is outer
        assert seen == [(0, 1, "inner", str(tmp_path))]
        assert res.metrics == {"rank": 0, "world": 1}
    finally:
        sess._set_session(None)
    ctx = mod.get_context()  # outside a worker: a context of one process
    assert (ctx.get_world_rank(), ctx.get_world_size(), ctx.get_checkpoint()) == (0, 1, None)
    ctx._stop_event.set()
    with pytest.raises(SystemExit):
        mod.report({"x": 1})
    sess._set_session(None)
