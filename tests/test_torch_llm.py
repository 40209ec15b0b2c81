"""The port's serving path (ray_tpu_torch.models.decoding,
continuous_batching, llm) held against the JAX package's on the CPU.

Model: the ``debug`` preset in fp32 (tests/test_llm.py's setup), JAX init
from key 0, converted with params_from_jax. Greedy tokens must be
identical; caches agree to 1e-5 abs (fp32, summation order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ids_tokenizer import IdsTokenizer
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.models import transformer as JT
from ray_tpu.models.decoding import Generator as JGenerator
from ray_tpu.models.decoding import SamplingParams as JSamplingParams
from ray_tpu.models.decoding import init_cache as jinit_cache
from ray_tpu.train.checkpoint import save_state as jax_save_state
from ray_tpu_torch.llm import ContinuousLLMEngine, LLMConfig, LLMEngine
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.continuous_batching import (
    ContinuousBatcher, _sample_per_slot)
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.decoding import (
    Generator, SamplingParams, _sample, init_cache)
from ray_tpu_torch.train import save_state

PROMPTS = [[7, 9, 11], [100, 2, 3, 4, 5, 6, 88], [5, 17, 3, 101, 42, 1, 2, 3, 4, 5, 6]]


@pytest.fixture(scope="module")
def models():
    jcfg = JT.config("debug", dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = T.config("debug", dtype=torch.float32, param_dtype=torch.float32)
    jparams = JT.init_params(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture
def batcher(models):
    _, _, tcfg, tparams = models
    b = ContinuousBatcher(tcfg, tparams, max_len=64, slots=2, device="cpu")
    yield b
    b.shutdown()
    b._thread.join(timeout=10)
    assert not b._thread.is_alive()


def test_generator_greedy_matches_jax_ragged_batch(models):
    jcfg, jparams, tcfg, tparams = models
    sp = dict(max_tokens=10)
    ref = JGenerator(jcfg, jparams, max_len=64).generate(PROMPTS, JSamplingParams(**sp))
    out = Generator(tcfg, tparams, max_len=64, device="cpu").generate(
        PROMPTS, SamplingParams(**sp))
    assert out == ref


def test_generator_cache_full_matches_jax(models):
    """One sequence fills its cache while another keeps decoding: JAX
    drops the writes past max_len, the port clamps them into the row of
    the stopped sequence. Both must emit the same tokens."""
    jcfg, jparams, tcfg, tparams = models
    prompts = [list(range(1, 13)), [3, 4]]
    sp = dict(max_tokens=12)
    ref = JGenerator(jcfg, jparams, max_len=16).generate(prompts, JSamplingParams(**sp))
    out = Generator(tcfg, tparams, max_len=16, device="cpu").generate(
        prompts, SamplingParams(**sp))
    assert out == ref
    assert len(out[0]) == 5 and len(out[1]) == 12


def test_prefill_cache_matches_jax_on_real_rows(models):
    """The port's prefill attends through the flash path over its fresh
    K/V; JAX attends to the length-masked cache. The cache rows < length
    hold the same K/V. Rows past a prompt's length (right padding) are
    not compared: they are never read, because prefill returns only the
    logits at length-1, and decode writes slot `length` before it attends
    and masks every slot above it."""
    jcfg, jparams, tcfg, tparams = models
    lens = np.array([len(p) for p in PROMPTS], np.int32)
    toks = np.zeros((len(PROMPTS), lens.max()), np.int32)
    for i, p in enumerate(PROMPTS):
        toks[i, :len(p)] = p
    jgen = JGenerator(jcfg, jparams, max_len=32)
    jlast, jcache = jgen._prefill(jparams, jnp.asarray(toks), jnp.asarray(lens),
                                  jinit_cache(jcfg, len(PROMPTS), 32))
    gen = Generator(tcfg, tparams, max_len=32, device="cpu")
    cache = init_cache(tcfg, len(PROMPTS), 32, device="cpu")
    with torch.no_grad():
        last = gen._prefill(torch.from_numpy(toks).long(),
                            torch.from_numpy(lens).long(), cache)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), atol=1e-4)
    for i, n in enumerate(lens):
        for ours, ref in ((cache.k, jcache.k), (cache.v, jcache.v)):
            np.testing.assert_allclose(ours[:, i, :n].numpy(),
                                       np.asarray(ref[:, i, :n]), atol=1e-5)
    assert cache.lengths.tolist() == lens.tolist()


def test_stream_and_stop_token(models):
    _, _, tcfg, tparams = models
    gen = Generator(tcfg, tparams, max_len=64, device="cpu")
    free = gen.generate([[1, 2, 3]], SamplingParams(max_tokens=10))[0]
    assert list(gen.generate_stream([1, 2, 3], SamplingParams(max_tokens=10))) == free
    stop = free[3]
    out = gen.generate([[1, 2, 3]], SamplingParams(max_tokens=10, stop_token_id=stop))[0]
    assert out == free[:free.index(stop)]


def test_batcher_greedy_matches_generator(models, batcher):
    _, _, tcfg, tparams = models
    sp = SamplingParams(max_tokens=9)
    ref = Generator(tcfg, tparams, max_len=64, device="cpu").generate(PROMPTS, sp)
    # 3 requests over 2 slots: the third joins when a slot frees
    futs = [batcher.submit(p, sp) for p in PROMPTS]
    assert [f.result(timeout=60) for f in futs] == ref
    assert batcher.stats["admitted"] == 3 and batcher.stats["finished"] == 3
    assert list(batcher.submit_stream(PROMPTS[0], sp)) == ref[0]


def test_batcher_cache_full_retires(models, batcher):
    """A request that fills its row stops at max_len, like Generator."""
    _, _, tcfg, tparams = models
    prompt = list(range(1, 60))
    sp = SamplingParams(max_tokens=20)
    ref = Generator(tcfg, tparams, max_len=64, device="cpu").generate([prompt], sp)
    assert batcher.submit(prompt, sp).result(timeout=60) == ref[0]
    assert len(ref[0]) == 64 - len(prompt) + 1


def test_prompt_too_long_raises(models, batcher):
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match="max_len"):
        Generator(tcfg, tparams, max_len=8, device="cpu").generate([list(range(8))])
    with pytest.raises(ValueError, match="max_len"):
        batcher.submit(list(range(64)))


def test_engine_text_matches_jax(models):
    """Same converted weights, same prompts: the same completion text."""
    jcfg, _, tcfg, _ = models
    prompts = ["hello world", "ray on a gpu", ""]
    sp = dict(max_tokens=12)
    jeng = JLLMEngine(JLLMConfig(model=jcfg, max_len=64, sampling=JSamplingParams(**sp)))
    params = params_from_jax(jax.tree.map(np.asarray, jeng.generator.params),
                             tcfg, "cpu")
    config = LLMConfig(model=tcfg, max_len=64, sampling=SamplingParams(**sp))
    eng = LLMEngine(config, params=params, device="cpu")
    assert eng.generate(prompts) == jeng.generate(prompts)
    ceng = ContinuousLLMEngine(config, params=params, device="cpu")
    try:
        futs = [ceng.submit(p) for p in prompts]
        assert [f.result(timeout=60) for f in futs] == eng.generate(prompts)
    finally:
        ceng.shutdown()
    assert not ceng.batcher._thread.is_alive()


@pytest.fixture(scope="module")
def tiny_paths(tmp_path_factory):
    """``tiny`` in fp32 from JAX's init (key 1) as numpy: written by orbax
    (JAX's save_state) and by DCP (the port's save_state of the same
    numpy, converted)."""
    root = tmp_path_factory.mktemp("params")
    jcfg = JT.config("tiny", dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = T.config("tiny", dtype=torch.float32, param_dtype=torch.float32)
    np_params = jax.tree.map(np.asarray, JT.init_params(jcfg, jax.random.key(1)))
    jax_save_state(jax.tree.map(jnp.asarray, np_params), str(root / "orbax"))
    tparams = params_from_jax(np_params, tcfg, "cpu")
    save_state(tparams, str(root / "dcp"))
    return jcfg, tcfg, tparams, str(root / "orbax"), str(root / "dcp")


def test_engine_params_path_matches_jax(tiny_paths):
    """LLMEngine and ContinuousLLMEngine serving a saved params tree give
    JAX's LLMEngine(params_path) greedy tokens."""
    jcfg, tcfg, _, orbax_dir, dcp_dir = tiny_paths
    sp = dict(max_tokens=12)
    jeng = JLLMEngine(JLLMConfig(model=jcfg, max_len=64, params_path=orbax_dir,
                                 sampling=JSamplingParams(**sp)))
    ref = jeng.generate_tokens(PROMPTS)
    config = LLMConfig(model=tcfg, max_len=64, params_path=dcp_dir,
                       sampling=SamplingParams(**sp))
    assert LLMEngine(config, device="cpu").generate_tokens(PROMPTS) == ref
    ceng = ContinuousLLMEngine(config, device="cpu")
    try:
        futs = [ceng.batcher.submit(p, SamplingParams(**sp)) for p in PROMPTS]
        assert [f.result(timeout=60) for f in futs] == ref
    finally:
        ceng.shutdown()
    assert not ceng.batcher._thread.is_alive()


def test_engine_params_path_equals_params(tiny_paths):
    """params_path restores the saved tree bit for bit and serves the
    tokens params= does; the two together raise."""
    _, tcfg, tparams, _, dcp_dir = tiny_paths
    config = LLMConfig(model=tcfg, max_len=64, params_path=dcp_dir,
                       sampling=SamplingParams(max_tokens=12))
    eng = LLMEngine(config, device="cpu")
    for (path, a), (_, b) in zip(sorted(_items(eng.generator.params)),
                                 sorted(_items(tparams))):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    given = LLMEngine(dataclasses.replace(config, params_path=None), params=tparams,
                      device="cpu")
    assert eng.generate(["hello world", "ray"]) == given.generate(["hello world", "ray"])
    with pytest.raises(ValueError, match="not both"):
        LLMEngine(config, params=tparams, device="cpu")


def _items(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _items(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_sampling_supports():
    """Sampling draws other numbers than jax.random: hold it by what it
    may return. Greedy rows are the argmax; top-k rows stay in the top k."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((4, 50)).astype(np.float32))
    top3 = set(torch.topk(logits[1], 3).indices.tolist())
    gen = torch.Generator().manual_seed(0)
    temps = torch.tensor([0.0, 1.0, 0.0, 2.0])
    topks = torch.tensor([0, 3, 5, 1])
    for _ in range(50):
        ids = _sample_per_slot(logits, gen, temps, topks)
        assert ids[0] == logits[0].argmax() and ids[2] == logits[2].argmax()
        assert int(ids[1]) in top3
        assert ids[3] == logits[3].argmax()  # top-1 is greedy at any temperature
        one = _sample(logits[1:2], gen, 0.7, 3)
        assert int(one[0]) in top3
    assert torch.equal(_sample(logits, gen, 0.0, 0), logits.argmax(-1))


def test_llm_processor_matches_jax(tiny_paths):
    """build_llm_processor over a Dataset of 3 blocks in local mode: the
    port's generated column (its engine from the DCP params, on the CPU)
    equals JAX's (from the orbax params), row for row; one engine a
    config and device serves every batch."""
    import ray_tpu
    import ray_tpu.data
    import ray_tpu.llm.batch as jax_batch
    import ray_tpu_torch
    import ray_tpu_torch.data
    import ray_tpu_torch.llm.batch as port_batch
    from ray_tpu.llm import build_llm_processor as jax_processor
    from ray_tpu_torch.llm import build_llm_processor

    jcfg, tcfg, _, orbax_dir, dcp_dir = tiny_paths
    rows = [{"prompt": f"msg {i} " * (i + 1), "i": i} for i in range(6)]
    sp = dict(max_tokens=8)

    def run(rt, process):
        rt.init(local_mode=True)
        try:
            ds = rt.data.from_items(rows, override_num_blocks=3)
            return process(ds).take_all()
        finally:
            rt.shutdown()

    ref = run(ray_tpu, jax_processor(
        JLLMConfig(model=jcfg, max_len=64, params_path=orbax_dir, tokenizer=IdsTokenizer(),
                   sampling=JSamplingParams(**sp)), batch_size=2))
    config = LLMConfig(model=tcfg, max_len=64, params_path=dcp_dir, tokenizer=IdsTokenizer(),
                       sampling=SamplingParams(**sp))
    try:
        got = run(ray_tpu_torch, build_llm_processor(config, batch_size=2, device="cpu"))
        assert len(port_batch._ENGINE_CACHE) == 1
        (eng,) = port_batch._ENGINE_CACHE.values()
        assert port_batch._engine_for(config, "cpu") is eng
        assert eng.device == torch.device("cpu")
    finally:
        port_batch._ENGINE_CACHE.clear()
        jax_batch._ENGINE_CACHE.clear()
    assert [r["generated"] for r in got] == [r["generated"] for r in ref]
    assert [(r["prompt"], r["i"]) for r in got] == [(r["prompt"], r["i"]) for r in ref]
    assert all(len(r["generated"].split()) == 8 for r in got)
