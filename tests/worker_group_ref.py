"""The pytest-process half of the port's worker-group tests
(tests/test_torch_worker_group*.py): a cluster of the port with fake
cards, JAX's reference run, and a fit under a deadline. The loops and
the actors run in the cluster's workers (tests/torch_ranks.py)."""

import contextlib
import os
import pickle
import threading

import ray_tpu_torch as rt
import sharded_step_ref as R
from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec, build_mesh as jbuild_mesh
from ray_tpu.train import step as JS
from ray_tpu_torch.accelerators.gpu import FAKE_GPUS_ENV

GROUP_DEADLINE = 120.0  # seconds a group's fit may take
WORLD, STEPS = 2, 2


@contextlib.contextmanager
def fake_card_cluster(cards=WORLD, num_cpus=4):
    """The port's cluster with ``cards`` fake cards (its workers inherit the
    variable, so a worker group's process group runs over gloo); no
    CUDA_VISIBLE_DEVICES for it to inherit. A task is sent at once, so
    the zygote imports torch while the caller computes its references."""
    before = {k: os.environ.pop(k, None) for k in (FAKE_GPUS_ENV, "CUDA_VISIBLE_DEVICES")}
    os.environ[FAKE_GPUS_ENV] = str(cards)
    try:
        rt.init(num_cpus=num_cpus)
    finally:
        os.environ.pop(FAKE_GPUS_ENV)
        os.environ.update({k: v for k, v in before.items() if v is not None})
    try:
        rt.remote(_warm_up).remote()
        yield
    finally:
        rt.shutdown()


def _warm_up():
    return None


def reference():
    """JAX's init of ``debug`` (fp32) on the data=2 CPU mesh, its state as
    state_from_jax takes it, the tokens, JAX's STEPS steps from it and
    the port's single-device grads at it."""
    jcfg, tcfg = R.configs("debug")
    mesh = jbuild_mesh(JMeshSpec(data=WORLD))
    jstate = JS.init_state(jcfg, JS.default_optimizer(jcfg, lr=R.LR), mesh, seed=0)
    state0, toks = R.np_state(jstate), R.tokens(jcfg.vocab_size)
    ref = R.jax_run(jcfg, mesh, jstate, {"tokens": toks}, steps=STEPS, with_eval=False)
    ref["single"] = R.single_device(tcfg, state0["params"], {"tokens": toks})
    return {"state": state0, "tokens": toks, "jax": ref}


def fit(trainer):
    """``trainer.fit()`` within GROUP_DEADLINE seconds."""
    out = {}
    t = threading.Thread(target=lambda: out.update(res=trainer.fit()), daemon=True)
    t.start()
    t.join(GROUP_DEADLINE)
    assert not t.is_alive(), f"the group's fit ran past {GROUP_DEADLINE:.0f} s"
    return out["res"]


def load(directory, name):
    with open(os.path.join(directory, f"{name}.pkl"), "rb") as f:
        return pickle.load(f)
