"""The port's train step (ray_tpu_torch.train) held against the JAX
package's (ray_tpu.train.step) on the CPU.

Both start from the JAX init (params, and optimizer state through
state_from_jax) and take the same numpy tokens; JAX runs on a one-device
CPU mesh. fp32 params and compute. Tolerances:

- loss, accuracy and grad_norm 2e-5 (tests/test_ops.py's fp32 output
  tolerance: the two frameworks sum in other orders; grads themselves
  are compared in tests/test_torch_loss.py);
- params after a step: within 2e-7 abs + 1e-5 rel, except for elements
  whose gradient sits at reassociation noise. Adam's first steps move
  every element by about lr * sign(g), so where g is noise the sign, and
  the step, may differ by up to 2 * lr per step: those elements are
  bounded by 2 * lr * steps and must be rare (under 0.1%).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import transformer as JT
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import step as JS
from ray_tpu_torch import train as S
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import state_from_jax
from ray_tpu_torch.parallel import MeshSpec as TMeshSpec

ATOL = 2e-5
LR = 3e-4
STEPS = 3
# name -> (preset, overrides): dense without remat, LoRA with remat and
# GQA, and mixture-of-experts (moe_debug: 4 experts, top-2)
CASES = {"dense": ("debug", {}), "lora": ("tiny", {"lora_rank": 8}),
         "moe": ("moe_debug", {})}


def _configs(case):
    name, kw = CASES[case]
    return (JT.config(name, dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            T.config(name, dtype=torch.float32, param_dtype=torch.float32, **kw))


def _tokens(vocab, b=2, s=32, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _np_state(jstate, case):
    """The JAX train state as state_from_jax takes it: Adam's moments of
    the trainable leaves (LoRA: the MaskedNodes of the frozen ones pruned)."""
    opt = jstate["opt_state"]
    mu, nu = (optax.tree_utils.tree_get(opt, n) for n in ("mu", "nu"))
    if case == "lora":
        mu, nu = {"lora": mu["lora"]}, {"lora": nu["lora"]}
    return {"params": _np(jstate["params"]), "mu": _np(mu), "nu": _np(nu),
            "count": np.asarray(optax.tree_utils.tree_get(opt, "count")),
            "step": np.asarray(jstate["step"])}


_RUNS = {}


def _jax_run(case):
    """JAX: the init state and the state and metrics after each of STEPS
    steps, as numpy (run once per case; the JAX compile is the slow part)."""
    if case not in _RUNS:
        jcfg, _ = _configs(case)
        mesh = build_mesh(MeshSpec(), [jax.devices()[0]])
        opt = JS.default_optimizer(jcfg, lr=LR)
        state = JS.init_state(jcfg, opt, mesh, seed=0)
        step = JS.make_train_step(jcfg, opt, mesh, donate=False)
        toks = _tokens(jcfg.vocab_size)
        states, metrics = [_np_state(state, case)], []
        for _ in range(STEPS):
            state, m = step(state, {"tokens": toks})
            states.append(_np_state(state, case))
            metrics.append({k: float(v) for k, v in m.items()})
        _RUNS[case] = (states, metrics, toks)
    return _RUNS[case]


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


def _assert_params_close(out, ref, steps):
    for path, a in _flat(out):
        a = a.float().numpy()
        b = dict(_flat(ref))[path].astype(np.float32)
        d = np.abs(a - b)
        noisy = d > 2e-7 + 1e-5 * np.abs(b)
        assert d.max() <= 2 * LR * steps + 1e-6, path
        assert noisy.mean() < 1e-3, (path, noisy.mean())


@pytest.mark.parametrize("case", ["dense", "lora", "moe"])
def test_train_steps_match_jax(case):
    """STEPS steps from the same init: loss, accuracy and grad_norm each
    step, and the params after each step."""
    _, tcfg = _configs(case)
    states, metrics, toks = _jax_run(case)
    run = S.make_train_step(tcfg, S.default_optimizer(tcfg, lr=LR), device="cpu")
    state = state_from_jax(states[0], tcfg, "cpu")
    frozen = {p: t.clone() for p, t in _flat(state["params"]) if not p.startswith("/lora")}
    for i in range(STEPS):
        state, m = run(state, {"tokens": toks})
        for k in ("loss", "accuracy", "grad_norm", "tokens"):
            np.testing.assert_allclose(float(m[k]), metrics[i][k], atol=ATOL,
                                       err_msg=f"step {i} {k}")
        _assert_params_close(state["params"], states[i + 1]["params"], i + 1)
        assert int(state["step"]) == i + 1 == int(state["opt_state"]["count"])
    if case == "lora":  # frozen leaves bit-unchanged, adapters moved
        for p, t in _flat(state["params"]):
            if p in frozen:
                assert torch.equal(t, frozen[p]), p
        for name in ("wq_a", "wq_b", "wv_a", "wv_b", "wi_a", "wi_b"):
            moved = state["params"]["lora"][name] != torch.from_numpy(
                states[0]["params"]["lora"][name])
            assert moved.flatten(1).any(1).all(), name


@pytest.mark.parametrize("case", ["dense", "lora", "moe"])
def test_state_from_jax_continues_the_run(case):
    """Two JAX steps, the state converted, one more step in the port:
    the port's params equal JAX's after its third step."""
    _, tcfg = _configs(case)
    states, metrics, toks = _jax_run(case)
    state = state_from_jax(states[2], tcfg, "cpu")
    assert int(state["opt_state"]["count"]) == 2 == int(state["step"])
    for path, t in _flat(state["opt_state"]["mu"]):
        np.testing.assert_array_equal(t.numpy(), dict(_flat(states[2]["mu"]))[path])
    run = S.make_train_step(tcfg, S.default_optimizer(tcfg, lr=LR), device="cpu")
    state, m = run(state, {"tokens": toks})
    np.testing.assert_allclose(float(m["loss"]), metrics[2]["loss"], atol=ATOL)
    _assert_params_close(state["params"], states[3]["params"], 1)


def test_state_from_jax_checks_shapes():
    _, tcfg = _configs("lora")
    states, _, _ = _jax_run("lora")
    bad = dict(states[0], mu={"lora": dict(states[0]["mu"]["lora"])})
    bad["mu"]["lora"]["wq_a"] = bad["mu"]["lora"]["wq_a"][:1]
    with pytest.raises(ValueError, match="wq_a"):
        state_from_jax(bad, tcfg, "cpu")


@pytest.mark.parametrize("clip", [False, True])
def test_adamw_matches_optax(clip):
    """The optimizer alone on random grads over 3 updates, LoRA mask: the
    clip (both branches of its select), the moments and the update, as
    optax computes them. Elementwise math only, so 1e-6 relative."""
    _, tcfg = _configs("lora")
    jcfg, _ = _configs("lora")
    rng = np.random.default_rng(3)
    shapes = T.param_shapes(tcfg)
    params = {p: rng.standard_normal(s).astype(np.float32) for p, (s, _) in _flat(shapes)}
    jopt = JS.default_optimizer(jcfg, lr=LR)
    jparams = jax.tree.map(jnp.asarray, _unflat(params, shapes))
    jstate = jopt.init(jparams)
    topt = S.default_optimizer(tcfg, lr=LR)
    # copies: jnp.asarray may alias the numpy buffers, and JAX reads them
    # asynchronously while the port updates its params in place
    tparams = _unflat({p: torch.tensor(v) for p, v in params.items()}, shapes)
    tstate = topt.init(tparams)
    scale = 10.0 if clip else 1e-3
    for _ in range(3):
        grads = {p: scale * rng.standard_normal(v.shape).astype(np.float32)
                 for p, v in params.items()}
        upd, jstate = jopt.update(jax.tree.map(jnp.asarray, _unflat(grads, shapes)),
                                  jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        tgrads = _unflat({p: torch.from_numpy(v) for p, v in grads.items()}, shapes)
        tg = S.step._units(T.trainable_leaves(tcfg, tgrads))
        norm = torch.stack([g.norm() for g in tg]).square().sum().sqrt()
        assert (float(norm) > 1.0) == clip
        topt.update_(S.step._units(T.trainable_leaves(tcfg, tparams)), tg,
                     tstate, norm)
    for path, a in _flat(tparams):
        np.testing.assert_allclose(a.numpy(), dict(_flat(_np(jparams)))[path],
                                   rtol=1e-6, atol=1e-7, err_msg=path)


def _unflat(flat, like, prefix=""):
    return {k: _unflat(flat, v, f"{prefix}/{k}") if isinstance(v, dict)
            else flat[f"{prefix}/{k}"] for k, v in like.items()}


def test_unported_step_options_raise():
    """The step's options the port takes since the pipeline: a mesh with
    stage (passes the checks; a MeshSpec then needs to be a DeviceMesh),
    ``num_microbatches`` without stages (ignored, as in JAX: the same
    step), a pipeline of two stages in this process (the unpipelined
    step's numbers, dense); and what still raises, naming its ROADMAP
    row: a MoE config under stage and sequence together."""
    _, tcfg = _configs("dense")
    opt = S.default_optimizer(tcfg)
    with pytest.raises(TypeError, match="DeviceMesh"):
        S.make_train_step(tcfg, opt, TMeshSpec(stage=2, tensor=2), device="cpu")
    toks = _tokens(tcfg.vocab_size, b=4)
    runs = {}
    for name, kw in (("plain", {}), ("micro", {"num_microbatches": 2}),
                     ("staged", {"num_microbatches": 2, "stages": 2})):
        st = S.init_state(tcfg, opt, seed=0, device="cpu")
        run = S.make_train_step(tcfg, opt, device="cpu", **kw)
        runs[name] = [{k: float(v) for k, v in run(st, {"tokens": toks})[1].items()}
                      for _ in range(2)]
    assert runs["micro"] == runs["plain"]
    for a, b in zip(runs["staged"], runs["plain"]):
        for k in ("loss", "accuracy", "grad_norm", "tokens"):
            np.testing.assert_allclose(a[k], b[k], atol=ATOL, err_msg=k)
    # MoE under fsdp, tensor and sequence is ported; under stage and
    # sequence together it is not
    _, moe = _configs("moe")
    with pytest.raises(TypeError, match="DeviceMesh"):
        S.make_train_step(moe, S.default_optimizer(moe), TMeshSpec(fsdp=4, tensor=2),
                          device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue C, MoE under stage"):
        S.make_train_step(moe, S.default_optimizer(moe), TMeshSpec(stage=2, sequence=2),
                          device="cpu")
