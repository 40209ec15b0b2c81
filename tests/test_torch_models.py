"""The port's transformer (ray_tpu_torch.models) held against the JAX
package's (ray_tpu.models.transformer) on the CPU.

Weights come from the JAX init through params_from_jax; tokens from
numpy.random.default_rng. Tolerances: fp32 logits 1e-4 abs (summation
order over a few layers); bf16 logits, see test_forward_bf16_matches_jax.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as JT
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.decoding import forward_cached, init_cache
from ray_tpu_torch.parallel import MeshSpec

FP32_ATOL = 1e-4


def _configs(name, dtype, **kw):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return (JT.config(name, dtype=jdt, param_dtype=jnp.float32, **kw),
            T.config(name, dtype=dtype, param_dtype=torch.float32, **kw))


_JAX_INIT = {}


def _weights(jcfg, tcfg):
    """JAX init (fp32 master weights, key 0; drawn once per preset — the
    JAX init is the slow part of this file) and its conversion."""
    name = (jcfg.vocab_size, jcfg.hidden, jcfg.layers)
    if name not in _JAX_INIT:
        _JAX_INIT[name] = JT.init_params(jcfg, jax.random.key(0))
    jparams = _JAX_INIT[name]
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jparams, tparams


def _tokens(vocab, b=2, s=24, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s), dtype=np.int32)


def _logits(jcfg, tcfg, jparams, tparams, toks):
    ref = JT.forward(jcfg, jparams, jnp.asarray(toks))
    out = T.forward(tcfg, tparams, torch.from_numpy(toks).long())
    return np.asarray(ref.astype(jnp.float32)), out.float().numpy()


@pytest.mark.parametrize("name", ["debug", "tiny"])
def test_forward_fp32_matches_jax(name):
    jcfg, tcfg = _configs(name, torch.float32)
    jparams, tparams = _weights(jcfg, tcfg)
    ref, out = _logits(jcfg, tcfg, jparams, tparams, _tokens(tcfg.vocab_size))
    np.testing.assert_allclose(out, ref, atol=FP32_ATOL)


def test_forward_bf16_matches_jax():
    """bf16 rounds at other places in the two frameworks (matmul
    accumulation, fused elementwise ops). The tolerance is the gap JAX
    itself shows between its fp32 and bf16 runs of the same weights: the
    port's bf16 logits may be no further from JAX's bf16 logits than that."""
    jcfg32, _ = _configs("debug", torch.float32)
    jcfg, tcfg = _configs("debug", torch.bfloat16)
    jparams, tparams = _weights(jcfg, tcfg)
    toks = _tokens(tcfg.vocab_size)
    ref32 = np.asarray(JT.forward(jcfg32, jparams, jnp.asarray(toks)))
    ref, out = _logits(jcfg, tcfg, jparams, tparams, toks)
    jax_gap = float(np.abs(ref - ref32).max())
    assert jax_gap > 0
    assert float(np.abs(out - ref).max()) <= jax_gap


def test_forward_lora_matches_jax():
    """LoRA deltas on q, v and gate, with nonzero B matrices."""
    jcfg, tcfg = _configs("debug", torch.float32, lora_rank=4)
    jparams, _ = _weights(*_configs("debug", torch.float32))
    np_params = jax.tree.map(np.asarray, jparams)
    rng = np.random.default_rng(1)
    np_params["lora"] = {
        name: 0.1 * rng.standard_normal(shape).astype(np.float32)
        for name, (shape, _) in T.param_shapes(tcfg)["lora"].items()}
    jparams = jax.tree.map(jnp.asarray, np_params)
    tparams = params_from_jax(np_params, tcfg, "cpu")
    ref, out = _logits(jcfg, tcfg, jparams, tparams, _tokens(tcfg.vocab_size))
    np.testing.assert_allclose(out, ref, atol=FP32_ATOL)


def test_forward_positions_match_jax():
    jcfg, tcfg = _configs("debug", torch.float32)
    jparams, tparams = _weights(jcfg, tcfg)
    toks = _tokens(tcfg.vocab_size, b=1, s=8)
    pos = np.arange(5, 13, dtype=np.int32)
    ref = JT.forward(jcfg, jparams, jnp.asarray(toks), positions=jnp.asarray(pos))
    out = T.forward(tcfg, tparams, torch.from_numpy(toks).long(),
                    positions=torch.from_numpy(pos).long())
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=FP32_ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rms_norm_matches_jax(dtype):
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ref = JT._rms_norm(jnp.asarray(x).astype(jdt), jnp.asarray(w), 1e-5)
    out = T._rms_norm(torch.from_numpy(x).to(dtype), torch.from_numpy(w), 1e-5)
    # same rounding order: normalise in fp32, cast, then scale in x's dtype
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)), atol=1e-5)


def test_rope_matches_jax():
    """Split-half rotation at llama3_8b's theta and positions up to 2047."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4, 128)).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 6)).astype(np.int32)
    ref = JT._rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    out = T._rope(torch.from_numpy(x), torch.from_numpy(pos).long(), 500000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("name", ["debug", "tiny", "llama3_8b", "llama2_7b_lora",
                                  "moe_debug", "mixtral_8x7b"])
def test_param_shapes_and_count_match_jax(name):
    jcfg, tcfg = JT.config(name), T.config(name)
    jshapes = jax.eval_shape(lambda: JT.init_params(jcfg, jax.random.key(0)))
    tshapes = T.param_shapes(tcfg)
    flat_j = {jax.tree_util.keystr(p): tuple(l.shape) for p, l in
              jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    flat_t = {jax.tree_util.keystr(p): l[0] for p, l in
              jax.tree_util.tree_flatten_with_path(
                  tshapes, is_leaf=lambda x: isinstance(x, tuple))[0]}
    assert flat_t == flat_j
    assert tcfg.num_params() == jcfg.num_params()


def test_init_params_scale():
    cfg = T.config("tiny", param_dtype=torch.float32)
    p = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    # normal / sqrt(fan_in), each layer drawn anew
    assert abs(float(p["blocks"]["wq"].std()) * cfg.hidden ** 0.5 - 1) < 0.02
    assert abs(float(p["blocks"]["wo_mlp"].std()) * cfg.mlp_hidden ** 0.5 - 1) < 0.02
    assert not torch.equal(p["blocks"]["wq"][0], p["blocks"]["wq"][1])
    assert torch.equal(p["ln_f"], torch.ones(cfg.hidden))


def test_params_from_jax_bf16_and_shape_check():
    tcfg = T.config("debug", param_dtype=torch.bfloat16)
    jparams, _ = _weights(*_configs("debug", torch.float32))
    # bf16 leaves arrive as ml_dtypes.bfloat16 arrays
    np_params = jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.bfloat16)), jparams)
    tparams = params_from_jax(np_params, tcfg, "cpu")
    assert tparams["blocks"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tparams["embed"].float().numpy(), np_params["embed"].astype(np.float32))
    np_params["blocks"]["wq"] = np_params["blocks"]["wq"][:1]
    with pytest.raises(ValueError, match="wq"):
        params_from_jax(np_params, tcfg, "cpu")


@pytest.mark.parametrize("name", list(JT.PRESETS))
def test_presets_match_jax(name):
    """Every preset equals the JAX package's field for field (dtypes by
    name)."""
    jcfg, tcfg = JT.PRESETS[name], T.PRESETS[name]
    assert set(T.PRESETS) == set(JT.PRESETS)
    for f in dataclasses.fields(JT.TransformerConfig):
        a, b = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            a, b = jnp.dtype(a).name, str(b).removeprefix("torch.")
        assert a == b, f.name
    assert [f.name for f in dataclasses.fields(T.TransformerConfig)] == [
        f.name for f in dataclasses.fields(JT.TransformerConfig)]


def test_unported_paths_raise():
    moe = T.config("moe_debug", dtype=torch.float32)
    params = T.init_params(moe, torch.Generator().manual_seed(0), "cpu")
    cache = init_cache(moe, 1, 8, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    pos = torch.arange(4)[None, :]
    with pytest.raises(NotImplementedError, match="dense-only"):
        forward_cached(moe, params, toks, pos, cache, None, prefill=True)
    dense = T.config("debug", dtype=torch.float32)
    params = T.init_params(dense, torch.Generator().manual_seed(0), "cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    # mesh axes the port does not take yet, by their ROADMAP.md Queue A item
    for spec, item in ((MeshSpec(fsdp=2), 3), (MeshSpec(tensor=2), 3),
                       (MeshSpec(sequence=2), 2), (MeshSpec(stage=2), 4)):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A item {item}"):
            T.forward(dense, params, toks, mesh=spec)
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md Queue A item {item}"):
            T.loss_fn(dense, params, {"tokens": toks}, mesh=spec)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 4"):
        T.loss_fn(dense, params, {"tokens": toks}, num_microbatches=2)
    with pytest.raises(TypeError, match="DeviceMesh"):  # a mesh is a DeviceMesh
        T.forward(dense, params, toks, mesh=MeshSpec())
