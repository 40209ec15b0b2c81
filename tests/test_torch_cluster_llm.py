"""The slice as a whole at a small size: ``tiny`` served from an actor in a
worker process of the port's cluster, on the CPU.

JAX's ``LLMEngine`` draws ``tiny``'s params (fp32, seed 0) and generates
greedily. The same params, converted with ``models/convert.py``, are
``put`` by the driver; an actor in a worker process of
``ray_tpu_torch.init()`` gets them from the store and builds
``LLMEngine(device="cpu")`` over them. Its greedy tokens and texts must
equal JAX's, and the params it serves must be the driver's bit for bit.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.llm.config import LLMConfig as JLLMConfig
from ray_tpu.llm.engine import LLMEngine as JLLMEngine
from ray_tpu.models import transformer as JT
from ray_tpu.models.decoding import SamplingParams as JSamplingParams
from ray_tpu_torch.llm import LLMConfig, LLMEngine, SamplingParams
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax

PROMPTS = [[7, 9, 11], [100, 2, 3, 4, 5, 6, 88], [5, 17, 3, 101, 42, 1, 2, 3, 4, 5, 6]]
TEXTS = ["hello world", "ray on a gpu", "q"]


class ServedTiny:
    """The engine in its own process: params from the store."""

    def __init__(self, config, boxed_ref):
        params = rt.get(boxed_ref[0])  # boxed: the constructor gets the ref
        self.engine = LLMEngine(config, params=params, device="cpu")
        self.fingerprint = fingerprint(params)

    def where(self):
        return os.getpid(), self.fingerprint

    def generate_tokens(self, ids):
        return self.engine.generate_tokens(ids)

    def generate(self, texts):
        return self.engine.generate(texts)


def fingerprint(params):
    def leaves(tree):
        for k in sorted(tree):
            v = tree[k]
            yield from (leaves(v) if isinstance(v, dict) else [v])
    return [int(t.contiguous().view(torch.int32).sum()) for t in leaves(params)]


@pytest.fixture(scope="module")
def jax_engine():
    jcfg = JT.config("tiny", dtype=jnp.float32, param_dtype=jnp.float32)
    return JLLMEngine(JLLMConfig(model=jcfg, max_len=64,
                                 sampling=JSamplingParams(max_tokens=10)))


def test_tiny_from_an_actor_process_matches_jax(jax_engine):
    tcfg = T.config("tiny", dtype=torch.float32, param_dtype=torch.float32)
    params = params_from_jax(jax.tree.map(np.asarray, jax_engine.generator.params), tcfg, "cpu")
    config = LLMConfig(model=tcfg, max_len=64, sampling=SamplingParams(max_tokens=10))
    rt.init(num_cpus=2)
    try:
        served = rt.remote(ServedTiny).remote(config, [rt.put(params)])
        pid, fp = rt.get(served.where.remote(), timeout=120)
        assert pid != os.getpid() and fp == fingerprint(params)
        assert rt.get(served.generate_tokens.remote(PROMPTS), timeout=120) == \
            jax_engine.generate_tokens(PROMPTS)
        assert rt.get(served.generate.remote(TEXTS), timeout=120) == \
            jax_engine.generate(TEXTS)
        rt.kill(served)
    finally:
        rt.shutdown()
