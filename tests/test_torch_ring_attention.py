"""The port's ring attention (ray_tpu_torch/ops/ring_attention.py) held
against the JAX package's ``ring_attention`` under shard_map on
``MeshSpec(sequence=4)``, at tests/test_ops.py's shapes: the forward
causal and not (b 2, s 64, h 4, d 16), the grads (b 1, s 32, h 2, d 8),
and GQA, 4 query / 2 KV heads, where JAX expands K/V (``gqa_expand``)
before its ring and the port sends them round un-expanded.

First as a ring of 4 driven in this process: each rank's per-rank loop
(``ring_attention_rank_fwd`` / ``_bwd``) is handed the blocks it would
receive, in ring order, with their source ranks. Then through the real
P2P transport, one spawned group of 4 gloo ranks (tests/torch_ranks.py)
running every case. fp32; tolerances tests/test_ops.py's: outputs 2e-5,
grads 5e-5. The grads are of (O * W).sum() for a random W.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_ranks
from ray_tpu.ops.attention import gqa_expand
from ray_tpu.ops.ring_attention import ring_attention
from ray_tpu.parallel import MeshSpec, build_mesh
from ray_tpu_torch.ops.ring_attention import (
    ring_attention_rank_bwd, ring_attention_rank_fwd,
)

try:  # jax >= 0.8 moved shard_map to the top level
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

ATOL, GRAD_ATOL, N = 2e-5, 5e-5, 4
# name → (b, s, h, hkv, d, causal)
CASES = {"causal": (2, 64, 4, 4, 16, True), "noncausal": (2, 64, 4, 4, 16, False),
         "grads": (1, 32, 2, 2, 8, True), "gqa": (1, 32, 4, 2, 8, True)}


def _inputs(name):
    b, s, h, hkv, d, _ = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name))
    q = rng.standard_normal((b, s, h, d), dtype=np.float32)
    k, v = (rng.standard_normal((b, s, hkv, d), dtype=np.float32) for _ in range(2))
    w = rng.standard_normal((b, s, h, d), dtype=np.float32)
    return q, k, v, w


@functools.lru_cache(maxsize=None)
def _jax(name):
    """JAX's ring over MeshSpec(sequence=4): O and the grads of (O * W).sum()."""
    q, k, v, w = _inputs(name)
    causal, h = CASES[name][5], CASES[name][2]
    spec = P(None, "sequence", None, None)

    def inner(q, k, v):
        k, v = gqa_expand(k, v, h)
        return ring_attention(q, k, v, axis_name="sequence", causal=causal)

    ring = jax.jit(shard_map(inner, mesh=build_mesh(MeshSpec(sequence=N)),
                             in_specs=(spec, spec, spec), out_specs=spec))
    o, vjp = jax.vjp(ring, *(jnp.asarray(a) for a in (q, k, v)))
    return {"o": np.asarray(o), **{n: np.asarray(g) for n, g in
                                   zip(("dq", "dk", "dv"), vjp(jnp.asarray(w)))}}


def _ring_in_one_process(name):
    """Every rank's per-rank loops, each handed the K/V blocks it would
    receive (rank my: from my, my-1, ..., in ring order) and, in the
    backward, each block's dK/dV accumulators."""
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(name))
    causal = CASES[name][5]
    qs, ks, vs, ws = (t.chunk(N, dim=1) for t in (q, k, v, w))
    order = [[(my - t) % N for t in range(N)] for my in range(N)]
    outs = [ring_attention_rank_fwd(qs[my], [(ks[s], vs[s], s) for s in order[my]],
                                    my, causal) for my in range(N)]
    dk = [torch.zeros_like(x) for x in ks]
    dv = [torch.zeros_like(x) for x in vs]
    dq = [ring_attention_rank_bwd(qs[my], *outs[my], ws[my],
                                  [(ks[s], vs[s], s, dk[s], dv[s]) for s in order[my]],
                                  my, causal) for my in range(N)]
    return {"o": torch.cat([o for o, _ in outs], 1).numpy(),
            **{n: torch.cat(g, 1).numpy() for n, g in (("dq", dq), ("dk", dk), ("dv", dv))}}


@pytest.mark.parametrize("name", list(CASES))
def test_ring_in_one_process_matches_jax(name):
    ref, got = _jax(name), _ring_in_one_process(name)
    np.testing.assert_allclose(got["o"], ref["o"], atol=ATOL)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[g], ref[g], atol=GRAD_ATOL, err_msg=g)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each case through ring_attention on 4 spawned gloo ranks (spawned
    first, so they start up while JAX compiles): per rank its results."""
    world = torch_ranks.World(N, tmp_path_factory.mktemp("ring"))
    try:
        cases = {}
        for name in CASES:
            q, k, v, w = _inputs(name)
            cases[name] = ("ring", dict(q=q, k=k, v=v, do=w, causal=CASES[name][5]))
        world.send(cases)
        for name in CASES:
            _jax(name)
        return world.results()
    finally:
        world.stop()


def test_ranks_import_no_jax(ranks):
    assert all(r["jax_imported"] == [] for r in ranks)


@pytest.mark.parametrize("name", list(CASES))
def test_ring_over_gloo_matches_jax(ranks, name):
    """Each rank's O and grads are its sequence shard of JAX's."""
    ref = _jax(name)
    s = CASES[name][1] // N
    for rank, r in enumerate(ranks):
        mine = slice(rank * s, (rank + 1) * s)
        np.testing.assert_allclose(r[name]["o"], ref["o"][:, mine], atol=ATOL,
                                   err_msg=f"rank {rank}")
        for g in ("dq", "dk", "dv"):
            np.testing.assert_allclose(r[name][g], ref[g][:, mine], atol=GRAD_ATOL,
                                       err_msg=f"rank {rank} {g}")


def test_sends_per_rank(ranks):
    """Per rank: the forward sends its K/V n - 1 times (2 tensors a step)
    and never the dead last rotation; the backward sends K/V n - 1 times
    and the dK/dV accumulators n times (the last brings them home)."""
    for r in ranks:
        for name in CASES:
            assert r[name]["sent"] == (2 * (N - 1), 2 * (N - 1) + 2 * N), (name, r[name]["sent"])


def test_world_deadline_ends_a_hung_group(tmp_path):
    """A spawned group that outlives its deadline is ended and fails its
    file, naming the ranks still alive (tests/torch_ranks.py World)."""
    world = torch_ranks.World(1, tmp_path, deadline=8.0)
    try:
        world.send({"nap": ("sleep", {"seconds": 120})})
        with pytest.raises(TimeoutError, match=r"ranks \[0\] of 1 still running 8 s"):
            world.results()
        assert not any(p.is_alive() for p in world.ctx.processes)
    finally:
        world.stop()
