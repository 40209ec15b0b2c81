"""The port's loss_fn, trainable_mask, remat and eval step
(ray_tpu_torch.models.transformer, ray_tpu_torch.train) held against the
JAX package's on the CPU.

Weights come from the JAX init (key 0; LoRA B matrices drawn nonzero with
numpy, so the adapters change the forward) through params_from_jax;
tokens and loss masks from numpy. fp32 params and compute. Tolerances:
loss, accuracy and tokens 2e-5, grads 5e-5 (tests/test_ops.py's fp32
tolerances: the two frameworks sum in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as JT
from ray_tpu.parallel.mesh import MeshSpec, build_mesh
from ray_tpu.train import step as JS
from ray_tpu_torch import train as S
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax

ATOL = 2e-5
GRAD_ATOL = 5e-5
# name -> (preset, overrides): dense without remat, LoRA with remat and GQA
CASES = {"dense": ("debug", {}), "lora": ("tiny", {"lora_rank": 8})}


def _configs(case):
    name, kw = CASES[case]
    return (JT.config(name, dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            T.config(name, dtype=torch.float32, param_dtype=torch.float32, **kw))


def _tokens(vocab, b=2, s=32, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)


def _mask(b=2, s=32, seed=1):
    return (np.random.default_rng(seed).random((b, s)) < 0.7).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


_PARAMS = {}


def _np_params(case):
    """The JAX init as numpy, LoRA B matrices made nonzero (once per case)."""
    if case not in _PARAMS:
        jcfg, _ = _configs(case)
        params = _np(jax.jit(lambda k: JT.init_params(jcfg, k))(jax.random.key(0)))
        rng = np.random.default_rng(2)
        for name in ("wq_b", "wv_b", "wi_b"):
            if "lora" in params:
                params["lora"][name] = 0.1 * rng.standard_normal(
                    params["lora"][name].shape).astype(np.float32)
        _PARAMS[case] = params
    return _PARAMS[case]


@pytest.mark.parametrize("case", ["dense", "lora"])
@pytest.mark.parametrize("masked", [False, True])
def test_loss_fn_and_grads_match_jax(case, masked):
    """loss_fn's loss, metrics and the grad of every leaf against
    jax.value_and_grad, with and without loss_mask."""
    jcfg, tcfg = _configs(case)
    np_params = _np_params(case)
    batch = {"tokens": _tokens(jcfg.vocab_size)}
    if masked:
        batch["loss_mask"] = _mask()
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(jcfg, p, b), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["tokens"] = tbatch["tokens"].long()
    (loss, m), grads = S.value_and_grad(
        tcfg, params_from_jax(np_params, tcfg, "cpu"), tbatch)
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL, err_msg=k)
    assert float(loss) == float(m["loss"])
    for path, g in _flat(grads):
        np.testing.assert_allclose(g.numpy(), dict(_flat(_np(jgrads)))[path],
                                   atol=GRAD_ATOL, err_msg=path)


@pytest.mark.parametrize("case", ["dense", "lora"])
def test_trainable_mask_matches_jax(case):
    jcfg, tcfg = _configs(case)
    jshapes = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
    jmask = dict(_flat(JT.trainable_mask(jcfg, jshapes)))
    tmask = dict(_flat(T.trainable_mask(tcfg, T.param_shapes(tcfg))))
    assert tmask == jmask
    assert any(jmask.values()) and (case == "dense") == all(jmask.values())




def test_remat_on_and_off_give_equal_grads():
    """The re-run forward repeats the same ops on the same inputs, so the
    grads are bit-equal."""
    _, tcfg = _configs("lora")
    params = params_from_jax(_np_params("lora"), tcfg, "cpu")
    batch = {"tokens": torch.from_numpy(_tokens(tcfg.vocab_size)).long()}
    (l1, _), g1 = S.value_and_grad(T.config(tcfg, remat=True), params, batch)
    (l0, _), g0 = S.value_and_grad(T.config(tcfg, remat=False), params, batch)
    assert float(l1) == float(l0)
    for (path, a), (_, b) in zip(_flat(g1), _flat(g0)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=path)


@pytest.mark.parametrize("case", ["dense", "lora"])
def test_eval_step_matches_jax(case):
    jcfg, tcfg = _configs(case)
    toks = _tokens(jcfg.vocab_size, seed=3)
    mesh = build_mesh(MeshSpec(), [jax.devices()[0]])
    ref = JS.make_eval_step(jcfg, mesh)(
        jax.tree.map(jnp.asarray, _np_params(case)), {"tokens": jnp.asarray(toks)})
    out = S.make_eval_step(tcfg, device="cpu")(
        params_from_jax(_np_params(case), tcfg, "cpu"), {"tokens": toks})
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), atol=ATOL, err_msg=k)
