"""The port's mixture of experts (ray_tpu_torch.models.transformer's
``moe_routing`` and ``_moe_mlp``, and MoE through ``loss_fn``) held
against the JAX package's on the CPU.

The JAX package dispatches with one-hot ``[k·T, E, C]`` tensors, the
port by index; the function is the same, so in fp32 the two differ only
by summation order. Inputs and weights come from numpy seeds (the loss
tests: the JAX init through params_from_jax). Tolerances: ``_moe_mlp``
and the loss 2e-5, grads 5e-5 (tests/test_ops.py's fp32 tolerances);
bf16, see test_moe_mlp_bf16_matches_jax.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as JT
from ray_tpu_torch import train as S
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax

ATOL = 2e-5
GRAD_ATOL = 5e-5
# B x S = 21 tokens: no multiple of moe_debug's 4 experts
B, SEQ = 3, 7


def _configs(dtype=torch.float32, **kw):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return (JT.config("moe_debug", dtype=jdt, param_dtype=jnp.float32, **kw),
            T.config("moe_debug", dtype=dtype, param_dtype=torch.float32, **kw))


def _layer(cfg, seed=0):
    """One layer's MoE weights, normal / sqrt(fan_in), and an input y."""
    rng = np.random.default_rng(seed)
    h, m, e = cfg.hidden, cfg.mlp_hidden, cfg.num_experts
    p = {"router": rng.standard_normal((h, e)) / h ** 0.5,
         "wi_gate": rng.standard_normal((e, h, m)) / h ** 0.5,
         "wi_up": rng.standard_normal((e, h, m)) / h ** 0.5,
         "wo_mlp": rng.standard_normal((e, m, h)) / m ** 0.5}
    y = rng.standard_normal((B, SEQ, h))
    return {k: v.astype(np.float32) for k, v in p.items()}, y.astype(np.float32)


def _jax_moe(jcfg, p, y):
    out = jax.jit(functools.partial(JT._moe_mlp, jcfg))(
        jnp.asarray(y).astype(jcfg.dtype), {k: jnp.asarray(v) for k, v in p.items()})
    return np.asarray(out.astype(jnp.float32))


def _port_moe(tcfg, p, y):
    out = T._moe_mlp(tcfg, torch.from_numpy(y).to(tcfg.dtype),
                     {k: torch.from_numpy(v) for k, v in p.items()})
    return out.float().numpy()


def _loop_slots(gate_idx, cap, num_experts):
    """Slots the plain way: walk the entries choice-major (every token's
    first choice, then every second choice), each taking its expert's
    next free slot; an entry past capacity is dropped."""
    t, k = gate_idx.shape
    used = [0] * num_experts
    slot, keep = [], []
    for c in range(k):
        for tok in range(t):
            e = int(gate_idx[tok, c])
            slot.append(used[e])
            keep.append(used[e] < cap)
            used[e] += 1
    return np.array(slot), np.array(keep)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_fp32_matches_jax(capacity_factor, k):
    """With and without capacity drops (0.5 forces them), top-1 and
    top-2, on a token count no multiple of the experts."""
    jcfg, tcfg = _configs(capacity_factor=capacity_factor, experts_per_token=k)
    p, y = _layer(tcfg)
    np.testing.assert_allclose(_port_moe(tcfg, p, y), _jax_moe(jcfg, p, y), atol=ATOL)
    r = T.moe_routing(tcfg, torch.from_numpy(y).reshape(B * SEQ, -1),
                      torch.from_numpy(p["router"]))
    if capacity_factor < 1:
        assert not bool(r.keep.all())  # the drop path is exercised


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_routing_matches_a_plain_loop(capacity_factor):
    """gate_idx are the top-k experts by the fp32 softmax, best first;
    gates renormalised over k; slots and drops as a Python loop over the
    choice-major entries gives them; capacity as JAX's Python float
    product, truncated."""
    _, tcfg = _configs(capacity_factor=capacity_factor)
    p, y = _layer(tcfg, seed=1)
    x = y.reshape(B * SEQ, -1)
    r = T.moe_routing(tcfg, torch.from_numpy(x), torch.from_numpy(p["router"]))
    t, k, e = B * SEQ, tcfg.experts_per_token, tcfg.num_experts
    assert r.capacity == max(4, int(capacity_factor * t * k / e))
    logits = x.astype(np.float64) @ p["router"].astype(np.float64)
    order = np.argsort(-logits, axis=-1)[:, :k]
    np.testing.assert_array_equal(r.gate_idx.numpy(), order)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    top = np.take_along_axis(probs, order, axis=-1)
    np.testing.assert_allclose(r.gate_vals.numpy(), top / top.sum(-1, keepdims=True),
                               atol=1e-6)
    slot, keep = _loop_slots(r.gate_idx.numpy(), r.capacity, e)
    np.testing.assert_array_equal(r.slot.numpy(), slot)
    np.testing.assert_array_equal(r.keep.numpy(), keep)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_mlp_bf16_matches_jax(capacity_factor):
    """bf16 rounds at other places in the two frameworks. The tolerance is
    the gap JAX itself shows between its fp32 and bf16 runs of the same
    inputs: each framework's bf16 result lies within that much of the
    fp32 one, so the two lie within twice of it of each other."""
    jcfg32, _ = _configs(capacity_factor=capacity_factor)
    jcfg, tcfg = _configs(torch.bfloat16, capacity_factor=capacity_factor)
    p, y = _layer(tcfg, seed=2)
    y = np.array(jnp.asarray(y).astype(jnp.bfloat16).astype(jnp.float32))
    ref32, ref = _jax_moe(jcfg32, p, y), _jax_moe(jcfg, p, y)
    jax_gap = float(np.abs(ref - ref32).max())
    assert jax_gap > 0
    assert float(np.abs(_port_moe(tcfg, p, y) - ref).max()) <= 2 * jax_gap


# name -> overrides of moe_debug
LOSS_CASES = {"moe": {}, "moe_lora": {"lora_rank": 4},
              "moe_drop": {"capacity_factor": 0.5}}
_PARAMS = {}


def _np_params(case):
    """The JAX init (key 0) as numpy, LoRA B matrices made nonzero. One
    init serves every case: the LoRA leaves have keys of their own, so
    the base leaves do not depend on lora_rank (nor on the capacity)."""
    if not _PARAMS:
        jcfg, _ = _configs(**LOSS_CASES["moe_lora"])
        params = jax.tree.map(np.array, jax.jit(
            lambda k: JT.init_params(jcfg, k))(jax.random.key(0)))
        rng = np.random.default_rng(2)
        for name in ("wq_b", "wv_b", "wi_b"):
            params["lora"][name] = 0.1 * rng.standard_normal(
                params["lora"][name].shape).astype(np.float32)
        _PARAMS["lora"] = params
    params = _PARAMS["lora"]
    if LOSS_CASES[case].get("lora_rank"):
        return params
    return {k: v for k, v in params.items() if k != "lora"}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


@pytest.mark.parametrize("case", list(LOSS_CASES))
def test_moe_loss_fn_and_grads_match_jax(case):
    """loss_fn's loss and metrics and the grad of every leaf against
    jax.value_and_grad. With LoRA the MLP adapters wi_a/wi_b are never
    read by the MoE MLP: their grads are exactly zero in both. With
    capacity factor 0.5 tokens drop and the loss stays finite."""
    jcfg, tcfg = _configs(**LOSS_CASES[case])
    np_params = _np_params(case)
    toks = np.random.RandomState(0).randint(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: JT.loss_fn(jcfg, p, {"tokens": t}), has_aux=True))(
            jax.tree.map(jnp.asarray, np_params), jnp.asarray(toks))
    (loss, m), grads = S.value_and_grad(
        tcfg, params_from_jax(np_params, tcfg, "cpu"),
        {"tokens": torch.from_numpy(toks).long()})
    assert np.isfinite(float(loss))
    for k in ("loss", "accuracy", "tokens"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), atol=ATOL, err_msg=k)
    jflat = dict(_flat(jax.tree.map(np.array, jgrads)))
    for path, g in _flat(grads):
        np.testing.assert_allclose(g.numpy(), jflat[path], atol=GRAD_ATOL, err_msg=path)
    if tcfg.lora_rank:
        for name in ("wi_a", "wi_b"):
            assert not grads["lora"][name].any() and not jflat[f"/lora/{name}"].any()
    # every expert of every layer routed some token, and the router learns
    assert bool((grads["blocks"]["wi_gate"].abs().sum((2, 3)) > 0).all())
    assert bool(grads["blocks"]["router"].abs().sum() > 0)


def test_moe_param_count():
    _, tcfg = _configs()
    params = T.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for _, t in _flat(params)) == tcfg.num_params()
    assert params["blocks"]["wi_gate"].shape == (2, 4, 128, 256)
    assert params["blocks"]["router"].shape == (2, 128, 4)


@pytest.mark.parametrize("name", ["debug", "moe_debug"])
def test_unread_leaf_raises(name):
    """Only LoRA's wi_a/wi_b under MoE may go unread by the loss: a leaf
    no config reads (here an extra block leaf) makes the grad raise, on
    the dense path and on MoE alike."""
    cfg = T.config(name, dtype=torch.float32, lora_rank=4)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params["blocks"]["unwired"] = torch.zeros(cfg.layers, 3)
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 8)))
    with pytest.raises(ValueError, match=r"blocks/unwired\[0\] is not read"):
        S.value_and_grad(cfg, params, {"tokens": toks})
