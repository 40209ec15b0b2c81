"""The port's disaggregated prefill (ray_tpu_torch/models/disagg_prefill.py)
held against the JAX package's (ray_tpu/models/disagg_prefill.py) on the
CPU.

tests/test_llm_paged.py:164 on the ``debug`` preset in fp32, JAX's init
from key 0 converted by models/convert.py: three prompts, 6 greedy tokens
each. JAX's DisaggPrefillEngine runs in JAX's local mode (its replicas
are threads; the KV rows still cross its shared-memory TensorChannel).
The port's runs in the port's local mode (``device="cpu"``), then on a
one-node cluster, each replica in a worker process of its own, the rows
crossing processes, its weights built in each replica from a callable.
Each run's tokens must equal JAX's engine's and the port's
single-process PagedBatcher's; the decode replica runs no prefill
(``prefill_tokens == 0``) and admits all three. The KV row the port's
prefill replica writes for a prompt equals JAX's within 2e-5 at the
prompt's positions and is zero past its bucket in both (the bucket's
padded positions hold K/V of pad tokens, which neither side reads and
which differ: JAX's prefill masks them out of the attention, the port's
causal flash prefill does not).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu.experimental.channel import TensorChannel as JTensorChannel
from ray_tpu.models import transformer as JT
from ray_tpu.models.decoding import SamplingParams as JSamplingParams
from ray_tpu.models.disagg_prefill import DisaggPrefillEngine as JDisagg
from ray_tpu.models.disagg_prefill import PrefillReplica as JPrefillReplica
from ray_tpu.models.disagg_prefill import _row_shape as j_row_shape
from ray_tpu_torch.experimental.channel import TensorChannel
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.decoding import SamplingParams
from ray_tpu_torch.models.disagg_prefill import DisaggPrefillEngine, PrefillReplica, _row_shape
from ray_tpu_torch.models.paged_kv import PagedBatcher

PROMPTS = [[5, 17, 3], [9, 9, 2, 1], [42]]  # tests/test_llm_paged.py:174
MAX_LEN, SLOTS, PAGE, MAX_TOKENS = 64, 4, 16, 6
TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jcfg = JT.config("debug", dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = T.config("debug", dtype=torch.float32, param_dtype=torch.float32)
    jparams = JT.init_params(jcfg, jax.random.key(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return jcfg, jparams, tcfg, np_params


@pytest.fixture(scope="module")
def want(models):
    """JAX's DisaggPrefillEngine (in JAX's local mode) and the port's
    single-process PagedBatcher on the three prompts (JAX's own test holds
    JAX's engine to JAX's PagedBatcher)."""
    jcfg, jparams, tcfg, np_params = models
    sp = JSamplingParams(max_tokens=MAX_TOKENS)
    ray_tpu.init(local_mode=True)
    try:
        eng = JDisagg(jcfg, jparams, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE)
        try:
            jax_disagg = [ray_tpu.get(r, timeout=300) for r in
                          [eng.generate(p, sp) for p in PROMPTS]]
            jax_stats = eng.stats()
        finally:
            eng.shutdown()
    finally:
        ray_tpu.shutdown()
    pb = PagedBatcher(tcfg, params_from_jax(np_params, tcfg, "cpu"), max_len=MAX_LEN,
                      slots=SLOTS, page_size=PAGE, device="cpu")
    try:
        port_paged = [f.result(timeout=120) for f in
                      [pb.submit(p, SamplingParams(max_tokens=MAX_TOKENS)) for p in PROMPTS]]
    finally:
        pb.shutdown()
    assert jax_disagg == port_paged
    assert jax_stats["prefill_tokens"] == 0 and jax_stats["admitted"] == len(PROMPTS)
    return jax_disagg


def run_port_engine(rt, tcfg, params, **kw):
    eng = DisaggPrefillEngine(tcfg, params, max_len=MAX_LEN, slots=SLOTS, page_size=PAGE,
                              device="cpu", **kw)
    try:
        sp = SamplingParams(max_tokens=MAX_TOKENS)
        outs = [rt.get(r, timeout=300) for r in [eng.generate(p, sp) for p in PROMPTS]]
        return outs, eng.stats()
    finally:
        eng.shutdown()


def test_local_mode_tokens_match_jax(models, want):
    """Both replicas are threads of this process, as on one card."""
    rt = ray_tpu_torch
    tcfg, np_params = models[2], models[3]
    rt.init(local_mode=True)
    try:
        outs, stats = run_port_engine(rt, tcfg, params_from_jax(np_params, tcfg, "cpu"))
    finally:
        rt.shutdown()
    assert outs == want
    assert stats["prefill_tokens"] == 0 and stats["admitted"] == len(PROMPTS)


def test_kv_row_matches_jax(models):
    """Each package's prefill replica (its local mode) writes the row of
    each prompt into its own channel: the rows and last logits agree."""
    jcfg, jparams, tcfg, np_params = models
    assert _row_shape(tcfg, MAX_LEN) == j_row_shape(jcfg, MAX_LEN)
    rows = {}
    for rt, pkg in ((ray_tpu, "jax"), (ray_tpu_torch, "torch")):
        rt.init(local_mode=True)
        try:
            if pkg == "jax":
                ch = JTensorChannel(j_row_shape(jcfg, MAX_LEN), "float32")
                rep = JPrefillReplica.remote(jcfg, jparams, MAX_LEN, ch)
            else:
                ch = TensorChannel(_row_shape(tcfg, MAX_LEN), "float32")
                rep = PrefillReplica.remote(tcfg, params_from_jax(np_params, tcfg, "cpu"),
                                            MAX_LEN, ch, "cpu")
            rd = ch.reader(0)
            rows[pkg] = []
            for p in PROMPTS:
                meta = rep.prefill.remote(p)
                row = rd.read(timeout=120)
                n, last = rt.get(meta, timeout=120)
                rows[pkg].append((n, np.asarray(last), row))
            ch.close()
        finally:
            rt.shutdown()
    for (jn, jlast, jrow), (tn, tlast, trow), p in zip(rows["jax"], rows["torch"], PROMPTS):
        assert jn == tn == len(p)
        assert trow.dtype == jrow.dtype == np.float32
        np.testing.assert_allclose(trow[:, :, :tn], jrow[:, :, :jn], rtol=0, atol=TOL)
        np.testing.assert_allclose(tlast, jlast, rtol=0, atol=TOL)
        assert not trow[:, :, 16:].any() and not jrow[:, :, 16:].any()  # past the bucket


@pytest.fixture(scope="module")
def cluster():
    rt = ray_tpu_torch
    rt.init(num_cpus=4)
    try:
        yield rt
    finally:
        rt.shutdown()


def test_cluster_replicas_match_jax(cluster, models, want):
    """Each replica in its own worker process, its weights converted there
    (``params`` a callable): the rows cross processes through the shared
    memory channel."""
    tcfg, np_params = models[2], models[3]
    build = functools.partial(params_from_jax, np_params, tcfg, "cpu")
    outs, stats = run_port_engine(cluster, tcfg, build, num_cpus=1)
    assert outs == want
    assert stats["prefill_tokens"] == 0 and stats["admitted"] == len(PROMPTS)
