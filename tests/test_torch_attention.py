"""The port's attention ops (ray_tpu_torch.ops.attention) held against the
JAX package's (ray_tpu.ops.attention) on the CPU.

Inputs come from numpy.random.default_rng and go to both. Tolerances:
fp32 outputs 2e-5 and grads 5e-5 (tests/test_ops.py's, summation order
only); the Pallas kernel, run in interpret mode, 2e-5 on O and LSE.
"""

import functools

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as JA
from ray_tpu_torch.ops import attention as PA

ATOL = 2e-5
GRAD_ATOL = 5e-5


def _qkv(seed, b=2, sq=128, h=4, hkv=None, d=32, sk=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d), dtype=np.float32)
    k = rng.standard_normal((b, sk or sq, hkv or h, d), dtype=np.float32)
    v = rng.standard_normal((b, sk or sq, hkv or h, d), dtype=np.float32)
    return q, k, v


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("causal", [True, False])
def test_mha_reference_matches_jax(causal):
    q, k, v = _qkv(0)
    ref = JA.mha_reference(*_j(q, k, v), causal=causal)
    out = PA.mha_reference(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_jax(causal):
    q, k, v = _qkv(1)
    ref = JA.blockwise_attention(*_j(q, k, v), causal=causal, block_k=32)
    out = PA.blockwise_attention(*_t(q, k, v), causal=causal, block_k=32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_blockwise_ragged_tail_matches_reference():
    # 100 keys in blocks of 32: the last block is short
    q, k, v = _qkv(2, sq=100)
    ref = PA.mha_reference(*_t(q, k, v))
    out = PA.blockwise_attention(*_t(q, k, v), block_k=32)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_attention_matches_jax(causal, hkv):
    """On a CPU tensor flash_attention is the plain version; it takes
    grouped KV heads directly, where JAX expands them first."""
    q, k, v = _qkv(3, h=4, hkv=hkv, sq=64)
    jq, jk, jv = _j(q, k, v)
    jk, jv = JA.gqa_expand(jk, jv, 4)
    ref = JA.flash_attention(jq, jk, jv, causal)
    out = PA.flash_attention(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL)


def test_gqa_expand_matches_jax():
    q, k, v = _qkv(4, h=8, hkv=2)
    jk, jv = JA.gqa_expand(*_j(k, v), 8)
    tk, tv = PA.gqa_expand(*_t(k, v), 8)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU
    (no JAX file changes: pallas_call is wrapped for this test only)."""
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


@pytest.mark.parametrize("sq,sk,causal", [
    (100, 100, True),   # padded to 128 by the kernel's 64-row blocks
    (64, 128, False),   # Sq != Sk
])
def test_flash_fwd_reference_matches_pallas_kernel(interpret_pallas, sq, sk,
                                                   causal):
    """The plain version computes what _flash_fwd_kernel computes: O and
    the LSE rows m + log(max(l, 1e-30))."""
    b, h, d = 1, 2, 32
    q, k, v = _qkv(5, b=b, sq=sq, sk=sk, h=h, d=d)
    o_ref, lse_ref = JA._flash_fwd_pallas(*_j(q, k, v), causal, None, 64, 64)
    lse_ref = np.asarray(lse_ref)[:, 0, :sq].reshape(b, h, sq)
    o, lse = PA.flash_attention_fwd(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=ATOL)


def test_flash_fwd_reference_gqa_is_expanded_mha():
    q, k, v = _qkv(6, h=8, hkv=2, sq=48, sk=80)
    tq, tk, tv = _t(q, k, v)
    o, lse = PA.flash_attention_fwd(tq, tk, tv, causal=True)
    ke, ve = PA.gqa_expand(tk, tv, 8)
    o2, lse2 = PA.flash_attention_fwd(tq, ke, ve, causal=True)
    np.testing.assert_allclose(o.numpy(), o2.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), lse2.numpy(), atol=1e-6)
    # LSE is the log of the softmax normalizer of the scaled, masked logits
    s = torch.einsum("bqhd,bkhd->bhqk", tq * 32 ** -0.5, ke)
    s = torch.where(torch.ones(48, 80).tril().bool(), s, -torch.inf)
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, -1).numpy(),
                               atol=ATOL)


@pytest.mark.parametrize("hkv", [4, 2])
def test_flash_attention_grad_matches_jax(hkv):
    """Autograd through the CPU path matches jax.grad (JAX differentiates
    its blockwise fallback off the TPU)."""
    q, k, v = _qkv(7, h=4, hkv=hkv, sq=64)
    w = np.random.default_rng(8).standard_normal((2, 64, 4, 32)).astype(np.float32)

    def jloss(q_, k_, v_):
        k_, v_ = JA.gqa_expand(k_, v_, 4)
        return (JA.flash_attention(q_, k_, v_) * w).sum()

    g_ref = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    (PA.flash_attention(tq, tk, tv) * torch.from_numpy(w)).sum().backward()
    for a, b in zip((tq.grad, tk.grad, tv.grad), g_ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GRAD_ATOL)


def test_cpu_path_does_not_count_launches():
    before = PA.flash_fwd_launches
    PA.flash_attention_fwd(*_t(*_qkv(9, sq=16)))
    assert PA.flash_fwd_launches == before


@pytest.mark.parametrize("bad", ["heads", "dims", "empty", "device"])
def test_flash_attention_fwd_rejects_bad_inputs(bad):
    q, k, v = _t(*_qkv(10, sq=16, h=4))
    if bad == "heads":
        k, v = k[:, :, :3], v[:, :, :3]
    elif bad == "dims":
        q = q[0]
    elif bad == "empty":
        k, v = k[:, :0], v[:, :0]
    else:
        q, k, v = (t.to("meta") for t in (q, k, v))
    with pytest.raises(ValueError):
        PA.flash_attention_fwd(q, k, v)
