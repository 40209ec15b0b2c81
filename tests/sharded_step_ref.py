"""The pytest-process half of the port's sharded-step tests
(tests/test_torch_sharded_step*.py): the JAX reference on the 8-device
CPU mesh, the port's single-device references, and the checks that hold
the ranks (tests/torch_ranks.py) to them. fp32 params and compute.

Tolerances: loss, accuracy and grad_norm 2e-5; grads 5e-5
(tests/test_ops.py's fp32 tolerances); params after the steps as
tests/test_torch_train.py holds them (2e-7 abs + 1e-5 rel, with elements
at reassociation noise bounded by 2·lr·steps and under 0.1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

import torch_ranks
from ray_tpu.models import transformer as JT
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import step as JS
from ray_tpu_torch import train as S
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax

ATOL, GRAD_ATOL = 2e-5, 5e-5
LR, STEPS, WORLD = torch_ranks.LR, 3, 8


def tokens(vocab, b=8, s=64, seed=0):
    """tests/test_models_train.py's and tests/test_moe_pipeline.py's tokens."""
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def configs(preset, **kw):
    return (JT.config(preset, dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            T.config(preset, dtype=torch.float32, param_dtype=torch.float32, **kw))


def np_state(jstate, lora=False):
    """The JAX train state as state_from_jax takes it (LoRA: the moments
    of the adapters only, the MaskedNodes of the frozen leaves pruned)."""
    opt = jstate["opt_state"]
    mu, nu = (jax.tree.map(np.array, optax.tree_utils.tree_get(opt, n)) for n in ("mu", "nu"))
    if lora:
        mu, nu = {"lora": mu["lora"]}, {"lora": nu["lora"]}
    return {"params": jax.tree.map(np.array, jstate["params"]), "mu": mu, "nu": nu,
            "count": np.asarray(optax.tree_utils.tree_get(opt, "count")),
            "step": np.asarray(jstate["step"])}


def items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def jax_run(jcfg, mesh, jstate, batch, steps=STEPS, with_eval=True):
    """JAX's eval metrics at ``jstate`` (unless not ``with_eval``) and each
    of ``steps`` steps' metrics; the params after them."""
    ev = JS.make_eval_step(jcfg, mesh)(jstate["params"], batch) if with_eval else {}
    step = JS.make_train_step(jcfg, JS.default_optimizer(jcfg, lr=LR), mesh, donate=False)
    metrics = []
    for _ in range(steps):
        jstate, m = step(jstate, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"eval": {k: float(v) for k, v in ev.items()}, "metrics": metrics,
            "params": dict(items(jax.tree.map(np.array, jstate["params"]))),
            "state": jstate}


def single_device(tcfg, np_params, batch, record_routing=False):
    """The port's single-device value_and_grad on the global batch: its
    metrics, grads by path and (optionally) each MoE layer's routing."""
    tbatch = torch_ranks.batch(batch["tokens"], batch.get("loss_mask"))
    with torch_ranks.record_routing(record_routing) as seen:
        (_, m), grads = S.value_and_grad(tcfg, params_from_jax(np_params, tcfg, "cpu"), tbatch)
    return {"metrics": {k: float(v) for k, v in m.items()}, "grads": dict(items(grads)),
            "routing": seen}


def dp_world(preset, kw, tmp_path, references=True):
    """A data-parallel case at MeshSpec(data=8): the ranks' train case
    (spawned first, so they start up while JAX compiles), JAX's run and,
    with ``references``, JAX's eval and the single-device grads."""
    world = torch_ranks.World(WORLD, tmp_path)
    try:
        jcfg, tcfg = configs(preset, **kw)
        mesh = build_mesh(MeshSpec(data=-1))
        jstate = JS.init_state(jcfg, JS.default_optimizer(jcfg, lr=LR), mesh, seed=0)
        state0, toks = np_state(jstate, bool(tcfg.lora_rank)), tokens(jcfg.vocab_size)
        world.send({"case": ("train", dict(preset=preset, overrides=kw, spec={"data": WORLD},
                                           state=state0, tokens=toks, steps=STEPS))})
        ref = jax_run(jcfg, mesh, jstate, {"tokens": toks}, with_eval=references)
        if references:
            ref["single"] = single_device(tcfg, state0["params"], {"tokens": toks})
        ref["params0"] = dict(items(state0["params"]))
        done = world.results()
    finally:
        world.stop()
    return {"ranks": [r["case"] for r in done], "jax": ref,
            "jax_imported": [r["jax_imported"] for r in done]}


def params_close(a, b, steps):
    d = np.abs(a - b)
    noisy = d > 2e-7 + 1e-5 * np.abs(b)
    return d.max() <= 2 * LR * steps + 1e-6 and noisy.mean() < 1e-3


def check_metrics(ranks, jax_metrics):
    """Each step's loss, accuracy, grad_norm and tokens, on every rank,
    against JAX's sharded step; the loss falls."""
    for rank, r in enumerate(ranks):
        for i, (m, jm) in enumerate(zip(r["metrics"], jax_metrics)):
            for k in ("loss", "accuracy", "grad_norm", "tokens"):
                np.testing.assert_allclose(m[k], jm[k], atol=ATOL,
                                           err_msg=f"rank {rank} step {i} {k}")
        assert r["metrics"][-1]["loss"] < r["metrics"][0]["loss"]
        assert r["step"] == (len(jax_metrics),) * 2


def check_params(ranks, jax_params, shard, steps=STEPS):
    """Each rank's params after the steps: ``shard(path, whole, rank)`` of
    JAX's."""
    for rank, r in enumerate(ranks):
        for path, a in items(r["params"]):
            b = shard(path, jax_params[path], rank)
            assert a.shape == b.shape, (rank, path)
            assert params_close(a, b, steps), (rank, path)


def check_grads(ranks, single, shard):
    """Every rank's global loss and grads (value_and_grad under the mesh)
    against ``shard(path, whole, rank)`` of the single-device ones."""
    for rank, r in enumerate(ranks):
        for k in ("loss", "accuracy", "tokens"):
            np.testing.assert_allclose(r["grad_metrics"][k], single["metrics"][k],
                                       atol=ATOL, err_msg=f"rank {rank} {k}")
        for path, g in items(r["grads"]):
            np.testing.assert_allclose(g, shard(path, single["grads"][path].numpy(), rank),
                                       atol=GRAD_ATOL, err_msg=f"rank {rank} {path}")


def check_eval(ranks, jax_eval):
    for r in ranks:
        for k, v in jax_eval.items():
            np.testing.assert_allclose(r["eval"][k], v, atol=ATOL, err_msg=k)


def whole(path, a, rank):
    """No leaf is cut over data."""
    return a
