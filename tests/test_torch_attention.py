"""The port's attention ops (ray_tpu_torch.ops.attention) held against the
JAX package's (ray_tpu.ops.attention) on the CPU.

Inputs come from numpy.random.default_rng and go to both. Tolerances:
fp32 outputs 2e-5 and grads 5e-5 (tests/test_ops.py's, summation order
only); the Pallas kernels, run in interpret mode, 2e-5 on O and LSE and
5e-5 on dQ, dK and dV.
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


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal", [
    (1, 128, 128, 2, 2, 128, True),   # the tensor-core kernel's head dim
    (1, 200, 200, 4, 2, 128, True),   # Sq no multiple of 128, GQA
    (1, 200, 200, 4, 2, 128, False),
])
def test_flash_fwd_reference_matches_pallas_kernel_d128(interpret_pallas, b, sq, sk,
                                                        h, hkv, d, causal):
    """The plain forward against _flash_fwd_kernel at D=128 and at ragged
    GQA tiles (JAX expands the KV heads, the port reads them grouped)."""
    q, k, v = _qkv(16, b=b, sq=sq, sk=sk, h=h, hkv=hkv, d=d)
    jq, jk, jv = _j(q, k, v)
    jk, jv = JA.gqa_expand(jk, jv, h)
    o_ref, lse_ref = JA._flash_fwd_pallas(jq, jk, jv, causal, None, 64, 64)
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


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,causal", [
    (1, 128, 128, 2, 2, 32, True),
    (1, 100, 100, 2, 2, 32, True),    # padded to 128 by the 64-row blocks
    (1, 128, 128, 2, 2, 32, False),   # non-causal
    (1, 64, 192, 2, 2, 32, True),     # Sq != Sk, top-left causal mask
    (1, 128, 128, 4, 2, 32, True),    # GQA: JAX expands, the port sums
    (1, 128, 128, 2, 2, 128, True),   # the tensor-core kernel's head dim
    (1, 200, 200, 4, 2, 128, True),   # Sq no multiple of 128, GQA
    # Sk > Sq, ragged key tile: trailing keys see no query (dK/dV zero)
    (1, 100, 300, 8, 2, 128, True),
])
def test_flash_bwd_reference_matches_pallas_kernels(interpret_pallas, b, sq,
                                                    sk, h, hkv, d, causal):
    """The plain backward computes what _flash_bwd_dq_kernel and
    _flash_bwd_dkv_kernel compute from the same O and LSE (the JAX LSE
    [B*H, 1, Sq_pad] reshaped to the port's [B, H, Sq]); with GQA the
    port's dK/dV are JAX's summed over each KV head's group."""
    q, k, v = _qkv(11, b=b, sq=sq, sk=sk, h=h, hkv=hkv, d=d)
    do = np.random.default_rng(12).standard_normal((b, sq, h, d), dtype=np.float32)
    jq, jk, jv = _j(q, k, v)
    jk, jv = JA.gqa_expand(jk, jv, h)
    o, lse = JA._flash_fwd_pallas(jq, jk, jv, causal, None, 64, 64)
    refs = JA._flash_bwd_pallas(jq, jk, jv, o, lse, jnp.asarray(do), causal,
                                None, 64, 64)
    lse = np.array(lse)[:, 0, :sq].reshape(b, h, sq)
    grads = PA.flash_attention_bwd(*_t(q, k, v, np.array(o), lse, do),
                                   causal=causal)
    for name, out, ref in zip("qkv", grads, refs):
        ref = np.asarray(ref)
        if name != "q":
            ref = ref.reshape(b, sk, hkv, h // hkv, d).sum(3)
        np.testing.assert_allclose(out.numpy(), ref, atol=GRAD_ATOL,
                                   err_msg=f"d{name}")


def test_flash_bwd_reference_is_autograd_of_forward():
    """Sq != Sk with GQA: the plain backward equals autograd through the
    plain forward (which differentiates the softmax directly)."""
    q, k, v = _t(*_qkv(13, h=8, hkv=2, sq=40, sk=72))
    do = torch.from_numpy(np.random.default_rng(14).standard_normal(
        (2, 40, 8, 32), dtype=np.float32))
    o, lse = PA._flash_fwd_reference(q, k, v)
    grads = PA._flash_bwd_reference(q, k, v, o, lse, do)
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    refs = torch.autograd.grad(PA._flash_fwd_reference(tq, tk, tv)[0],
                               (tq, tk, tv), do)
    for out, ref in zip(grads, refs):
        np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=GRAD_ATOL)


def test_cpu_path_does_not_count_launches():
    counters = ("flash_fwd_launches", "flash_bwd_dq_launches",
                "flash_bwd_dkv_launches")
    before = [getattr(PA, c) for c in counters]
    q, k, v = (t.requires_grad_() for t in _t(*_qkv(9, sq=16)))
    PA.flash_attention(q, k, v).sum().backward()
    assert [getattr(PA, c) for c in counters] == before


def test_flash_attention_bwd_rejects_bad_inputs():
    q, k, v = _t(*_qkv(15, sq=16, h=4))
    o, lse = PA.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        PA.flash_attention_bwd(q, k, v, o, lse.transpose(1, 2), o)
    with pytest.raises(ValueError, match="do"):
        PA.flash_attention_bwd(q, k, v, o, lse, o[:, :8])


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


def _by_hand(q, k, v, do, round_p, round_ds):
    """The plain versions' arithmetic written out for MHA, with or without
    rounding P and dS to bf16 before the products they feed: (O, dQ, dV)."""
    dtype = q.dtype
    scale = q.shape[-1] ** -0.5
    qf, kf, vf, dof = q.float() * scale, k.float(), v.float(), do.float()
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qi = torch.arange(q.shape[1])[:, None]
    s = torch.where(qi >= torch.arange(k.shape[1])[None, :], s, PA.NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    pr = p.to(dtype).float() if round_p else p
    o = torch.einsum("bhqk,bkhd->bqhd", pr, vf) / l.transpose(1, 2)
    lse = (m + torch.log(l))[..., 0]
    p = torch.exp(s - lse[..., None])
    p = torch.where(qi >= torch.arange(k.shape[1])[None, :], p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - PA._flash_bwd_delta(o.to(dtype), do)[..., None])
    ds = ds.to(dtype).float() if round_ds else ds
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dtype).float() if round_p else p, dof)
    return o.to(dtype), dq.to(dtype), dv.to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plain_versions_round_p_and_ds_to_input_dtype(dtype):
    """In bf16 the plain versions round P (before P·V and Pᵀ·dO) and dS
    (before dS·K) to bf16, as the tensor-core kernels must; in fp32 that
    rounding is the identity and they compute what they did before."""
    q, k, v = (t.to(dtype) for t in _t(*_qkv(17, b=1, sq=64, h=2, d=32)))
    do = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (1, 64, 2, 32), dtype=np.float32)).to(dtype)
    o, lse = PA._flash_fwd_reference(q, k, v)
    dq, _, dv = PA._flash_bwd_reference(q, k, v, o, lse, do)
    rounded = _by_hand(q, k, v, do, round_p=True, round_ds=True)
    unrounded = _by_hand(q, k, v, do, round_p=False, round_ds=False)
    for name, got, want, other in zip(("o", "dq", "dv"), (o, dq, dv), rounded, unrounded):
        np.testing.assert_array_equal(got.float().numpy(), want.float().numpy(),
                                      err_msg=name)
        assert torch.equal(got, other) == (dtype == torch.float32), name


def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("bad", ["base", "head_stride", "seq_stride", "batch_stride"])
def test_tma_preconditions_raise(bad):
    """The tensor-core kernels read bf16 operands by TMA: a base address or
    a batch/sequence/head stride that is no multiple of 16 bytes raises
    before any launch, from the tensor's metadata alone."""
    if bad == "base":  # one element (2 bytes) past an aligned allocation
        t = _bf16(2 * 8 * 4 * 32 + 1)[1:].view(2, 8, 4, 32)
    elif bad == "head_stride":  # 36 columns per head row: 72 bytes
        t = _bf16((2, 8, 4, 36))[..., :32]
    elif bad == "seq_stride":  # 3 heads of 36 padded to 108 columns: 216 bytes
        t = _bf16((2, 8, 108))[..., :96].view(2, 8, 3, 32)
    else:  # batches 8 x 4 x 32 + 4 elements apart: 2056 bytes
        t = _bf16((2, 8 * 4 * 32 + 4))[:, :8 * 4 * 32].view(2, 8, 4, 32)
    name = {"base": "base address", "head_stride": "head stride",
            "seq_stride": "sequence stride", "batch_stride": "batch stride"}[bad]
    with pytest.raises(ValueError, match=f"q: TMA needs a.*{name.split()[0]}"):
        PA._check_tma_operands(q=t)


@pytest.mark.parametrize("case", ["contiguous", "head_slice", "extent_one"])
def test_tma_preconditions_accept(case):
    """Contiguous [B, S, H, D], a slice of heads (strides stay multiples of
    16 bytes), and a dim of extent 1 whose stride is never stepped over."""
    if case == "contiguous":
        t = _bf16((2, 8, 4, 32))
    elif case == "head_slice":
        t = _bf16((2, 8, 6, 32))[:, :, 1:5]
    else:  # extent-1 batch and head dims with strides TMA could not take
        t = torch.as_strided(_bf16(8 * 32), (1, 8, 1, 32), (3, 32, 5, 1))
    PA._check_tma_operands(q=t, k=t, v=t)
