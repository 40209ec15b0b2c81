"""The port's paged KV cache (ray_tpu_torch.models.paged_kv) held against
the JAX package's (ray_tpu/models/paged_kv.py) on the CPU.

Model: the ``debug`` preset in fp32, JAX init from key 0, converted with
params_from_jax (tests/test_llm_paged.py's setup). Page bookkeeping and
prefix keys must be identical; greedy tokens identical to JAX's
PagedBatcher and to the port's slot-dense ContinuousBatcher; the
continuation prefill over a reused prefix (two plain flash calls and the
log-sum-exp merge on the CPU) within 2e-5 of JAX's ``_prefill_impl``.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import transformer as JT
from ray_tpu.models.decoding import SamplingParams as JSamplingParams
from ray_tpu.models.paged_kv import PagedBatcher as JPagedBatcher
from ray_tpu.models.paged_kv import PagedKV as JPagedKV
from ray_tpu.models.paged_kv import prefix_keys as jprefix_keys
from ray_tpu_torch.models import transformer as T
from ray_tpu_torch.models.continuous_batching import ContinuousBatcher
from ray_tpu_torch.models.convert import params_from_jax
from ray_tpu_torch.models.decoding import SamplingParams
from ray_tpu_torch.models.paged_kv import KVPoolExhausted, PagedBatcher, PagedKV, prefix_keys

PROMPTS = [[5, 17, 3], [100, 2, 3, 4, 5, 6, 88], [9], [1, 2]]  # tests/test_llm_paged.py:74
SHARED = list(range(1, 33))  # exactly 2 full pages of 16 (tests/test_llm_paged.py:97)
TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    jcfg = JT.config("debug", dtype=jnp.float32, param_dtype=jnp.float32)
    tcfg = T.config("debug", dtype=torch.float32, param_dtype=torch.float32)
    jparams = JT.init_params(jcfg, jax.random.key(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return jcfg, jparams, tcfg, tparams


@pytest.fixture
def make(models):
    """make(kind, **kw): a port ("paged", "dense") or JAX ("jax") batcher
    of the debug model, shut down after the test."""
    jcfg, jparams, tcfg, tparams = models
    made = []

    def _make(kind="paged", **kw):
        if kind == "jax":
            b = JPagedBatcher(jcfg, jparams, **kw)
        elif kind == "dense":
            b = ContinuousBatcher(tcfg, tparams, device="cpu", **kw)
        else:
            b = PagedBatcher(tcfg, tparams, device="cpu", **kw)
        made.append(b)
        return b

    yield _make
    for b in made:
        b.shutdown()
        assert not b._thread.is_alive()


def run(batcher, prompts, max_tokens, timeout=120):
    cls = JSamplingParams if isinstance(batcher, JPagedBatcher) else SamplingParams
    sp = cls(max_tokens=max_tokens)
    return [f.result(timeout=timeout) for f in [batcher.submit(p, sp) for p in prompts]]


def _state(kv):
    return (kv.rc.tolist(), list(kv.free), dict(kv.prefix_map), dict(kv.page_key),
            dict(kv.stats))


def test_page_pool_and_prefix_keys_match_jax():
    """A seeded random walk of alloc, incref, decref, register and lookup
    on both pools: every return value, exception and the whole state
    (refcounts, LRU free order, prefix map, stats) identical."""
    rng = random.Random(0)
    ours, theirs = PagedKV(12, 4), JPagedKV(12, 4)
    seen = []  # token lists registered so far, for lookups that hit
    for _ in range(600):
        op = rng.choice(("alloc", "alloc", "incref", "decref", "decref", "register", "lookup"))
        live = [p for p in range(1, 12) if ours.rc[p] > 0]
        if op == "alloc":
            got = []
            for kv in (ours, theirs):
                try:
                    got.append(kv.alloc())
                except RuntimeError as e:
                    got.append(type(e).__name__)
            assert got[0] == got[1]
        elif op == "incref":
            cached = [p for p in ours.free if p in ours.page_key]
            pick = live + cached
            if pick:
                p = rng.choice(pick)
                ours.incref(p)
                theirs.incref(p)
        elif op == "decref" and live:
            p = rng.choice(live)
            ours.decref(p)
            theirs.decref(p)
        elif op == "register":
            toks = [rng.randrange(5) for _ in range(rng.randrange(17))]
            keys = prefix_keys(toks, 4)
            assert keys == jprefix_keys(toks, 4)
            if live and keys:
                pages = [rng.choice(live) for _ in keys]
                ours.register_prefix(keys, pages)
                theirs.register_prefix(keys, pages)
                seen.append(toks)
        elif op == "lookup":
            toks = (rng.choice(seen) + [rng.randrange(5) for _ in range(rng.randrange(6))]
                    if seen and rng.random() < 0.7 else
                    [rng.randrange(5) for _ in range(rng.randrange(17))])
            keys = prefix_keys(toks, 4)
            assert ours.lookup_prefix(keys) == theirs.lookup_prefix(keys)
        assert _state(ours) == _state(theirs)
    assert ours.stats["prefix_hit_pages"] > 0 and ours.stats["evicted_entries"] > 0
    with pytest.raises(KVPoolExhausted):
        PagedKV(1, 4).alloc()


def test_greedy_matches_jax_and_dense_batcher(make):
    """tests/test_llm_paged.py:70's prompts: the paged batcher's greedy
    tokens equal JAX's paged batcher's and the port's slot-dense one's."""
    ours = run(make(max_len=64, slots=4, page_size=16), PROMPTS, 10)
    assert ours == run(make("jax", max_len=64, slots=4, page_size=16), PROMPTS, 10)
    assert ours == run(make("dense", max_len=64, slots=4), PROMPTS, 10)


def test_shared_prefix_stats_match_jax(make):
    """tests/test_llm_paged.py:91-124: the second prompt prefills only the
    tokens past the two shared pages; stats equal JAX's after each
    request, and the tokens equal a cold batcher's."""
    p1, p2 = SHARED + [40, 41, 42], SHARED + [50, 51]
    pb = make(max_len=64, slots=2, page_size=16, extra_pages=8)
    jb = make("jax", max_len=64, slots=2, page_size=16, extra_pages=8)
    outs = []
    for p in (p1, p2):
        outs.append(run(pb, [p], 4)[0])
        assert outs[-1] == run(jb, [p], 4)[0]
        assert pb.stats == jb.stats
        assert pb.kv.stats == jb.kv.stats
    assert pb.stats["prefill_tokens"] == len(p1) + len(p2) - 32
    assert pb.stats["prefix_hit_tokens"] == 32
    assert outs[1] == run(make(max_len=64, slots=2, page_size=16), [p2], 4)[0]


def test_continuation_prefill_matches_jax(models, make):
    """The warm prefill: the remainder's queries over the reused prefix
    (pages written from JAX's own cold prefill row) and themselves.
    Last logits and the remainder's K/V within 2e-5 of JAX's
    _prefill_impl."""
    jcfg, jparams, tcfg, _ = models
    rem = [50, 51, 52, 7, 9]
    n, plen, bucket, max_len = len(SHARED) + len(rem), len(SHARED), 16, 64
    jb = make("jax", max_len=max_len, slots=2, page_size=16)
    zeros = jnp.zeros((jcfg.layers, max_len, jcfg.kv_heads, jcfg.hd), jnp.float32)
    toks = np.zeros((1, 64), np.int32)
    toks[0, :len(SHARED)] = SHARED
    _, jrow_k, jrow_v = jb._prefill_impl(jparams, jnp.asarray(toks), jnp.asarray([plen]),
                                         zeros, zeros, jnp.asarray(0, np.int32))
    prefix_k = jnp.where(jnp.arange(max_len)[None, :, None, None] < plen, jrow_k, 0)
    prefix_v = jnp.where(jnp.arange(max_len)[None, :, None, None] < plen, jrow_v, 0)
    rtoks = np.zeros((1, bucket), np.int32)
    rtoks[0, :len(rem)] = rem
    jlast, jk, jv = jb._prefill_impl(jparams, jnp.asarray(rtoks), jnp.asarray([n]),
                                     prefix_k, prefix_v, jnp.asarray(plen, np.int32))

    pb = make(max_len=max_len, slots=2, page_size=16)
    pages = [pb.kv.alloc(), pb.kv.alloc()]
    with torch.no_grad():
        pb._install(torch.from_numpy(np.array(jrow_k[:, :plen])),
                    torch.from_numpy(np.array(jrow_v[:, :plen])), pages)
        last, k, v = pb._prefill(torch.from_numpy(rtoks).long(), n, pages)
    assert k.shape == (tcfg.layers, bucket, tcfg.kv_heads, tcfg.hd)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=0, atol=TOL)
    real = slice(plen, plen + len(rem))
    np.testing.assert_allclose(k[:, :len(rem)].numpy(), np.asarray(jk[:, real]), rtol=0, atol=TOL)
    np.testing.assert_allclose(v[:, :len(rem)].numpy(), np.asarray(jv[:, real]), rtol=0, atol=TOL)


def test_submit_prefilled_and_stream_match_submit(make):
    """A row prefilled by one batcher, admitted whole by another, decodes
    to the same tokens; so does submit_stream."""
    prompt = [100, 2, 3, 4, 5, 6, 88]
    src = make(max_len=64, slots=2, page_size=16)
    want = run(src, [prompt], 8)[0]
    toks = np.zeros((1, 16), np.int64)
    toks[0, :len(prompt)] = prompt
    with torch.no_grad():
        last, row_k, row_v = src._prefill(torch.from_numpy(toks), len(prompt), [])
    dst = make(max_len=64, slots=2, page_size=16)
    got = dst.submit_prefilled(prompt, row_k, row_v, last, SamplingParams(max_tokens=8))
    assert got.result(timeout=120) == want
    assert dst.stats["prefill_tokens"] == 0 and dst.stats["admitted"] == 1
    assert list(src.submit_stream(prompt, SamplingParams(max_tokens=8))) == want


@pytest.mark.parametrize("slots,num_pages", [(2, 6), (3, 6), (4, 7)])
def test_overcommit_preempts_and_recovers(make, slots, num_pages):
    """tests/test_llm_paged.py:146-161 (2 slots, 6 pages where 9 would
    hold every sequence) and two pools where a sweep of lazy growth
    preempts a slot it has yet to reach: every request completes at its
    max_tokens with the tokens of a pool that never runs out (a preempted
    request re-prefills over its prompt and its output, each once), and
    no page is leaked. JAX's batcher fails both larger cases with a
    KeyError (ROADMAP.md Queue C)."""
    prompts = [[i, i + 1, i + 2] for i in range(4)]
    want = run(make(max_len=64, slots=4, page_size=16), prompts, 40)
    pb = make(max_len=64, slots=slots, page_size=16, num_pages=num_pages)
    outs = run(pb, prompts, 40, timeout=300)
    assert outs == want
    assert pb.stats["preempted"] >= 1, pb.stats
    assert pb.kv.rc.tolist() == [1] + [0] * (num_pages - 1)
    assert len(pb.kv.free) == num_pages - 1


def test_pool_stays_put_and_decode_steps_alike(make):
    """What JAX's decode_cache_size guards, in eager PyTorch: the pool
    is written in place (its data_ptr never changes), and every decode
    step runs the same torch calls whatever its lengths and pages."""
    pb = make(max_len=64, slots=2, page_size=16)
    ptrs = (pb.pool_k.data_ptr(), pb.pool_v.data_ptr())
    run(pb, PROMPTS, 6)
    run(pb, [list(range(20)), [7, 8]], 3)
    assert (pb.pool_k.data_ptr(), pb.pool_v.data_ptr()) == ptrs

    class Count(torch.overrides.TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.calls = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            self.calls.append(getattr(func, "__name__", str(func)))
            return func(*args, **(kwargs or {}))

    calls = []
    for lengths, table, active in (([3, 40], [[1, 0, 0, 0], [2, 3, 4, 0]], [True, True]),
                                   ([17, 5], [[5, 6, 0, 0], [0, 0, 0, 0]], [True, False])):
        with torch.no_grad(), Count() as c:
            pb._decode(torch.tensor([1, 2]), torch.tensor(table), torch.tensor(lengths),
                       torch.zeros(2), torch.zeros(2, dtype=torch.int64),
                       torch.tensor(active))
        calls.append(c.calls)
    assert calls[0] == calls[1] and len(calls[0]) > 0
    assert (pb.pool_k.data_ptr(), pb.pool_v.data_ptr()) == ptrs


def test_requeue_on_exhaustion_leaks_no_page(make):
    """A prompt that finds the pool held by an active sequence is
    requeued at the front (its partial allocation given back), then
    admitted once the pages return; at the end every page is free."""
    pb = make(max_len=64, slots=2, page_size=16, num_pages=5)
    raised = []
    alloc = pb.kv.alloc

    def counting_alloc():
        try:
            return alloc()
        except KVPoolExhausted:
            raised.append(dict(pb.kv.stats))
            raise

    pb.kv.alloc = counting_alloc
    sp = SamplingParams(max_tokens=8)
    first = pb.submit(list(range(1, 41)), sp)  # 40 tokens: 3 pages, then 4
    second = pb.submit(list(range(50, 80)), sp)  # 30 tokens: 2 pages
    outs = [first.result(timeout=120), second.result(timeout=120)]
    assert [len(o) for o in outs] == [8, 8]
    assert raised, "the second prompt never met an exhausted pool"
    assert pb.stats["preempted"] == 0 and pb.stats["finished"] == 2
    assert pb.kv.rc.tolist() == [1, 0, 0, 0, 0] and len(pb.kv.free) == 4
    ref = make(max_len=64, slots=2, page_size=16)
    assert outs == run(ref, [list(range(1, 41)), list(range(50, 80))], 8)
