"""Attention ops, GPU-first (PyTorch port of ray_tpu/ops/attention.py).

Three tiers, all the same math (softmax(QK^T * scale + mask) V):

- `mha_reference`   : plain torch, O(S^2) memory — ground truth for tests.
- `blockwise_attention` : online softmax over KV chunks in a Python loop —
  O(S * block) memory, differentiable by autograd.
- `flash_attention` : the FlashAttention-2 kernels written for Hopper on
  a CUDA tensor: the forward and, under autograd, the dQ and dK/dV
  backward passes. The kernel is chosen by dtype: bf16 runs all three on
  the tensor cores (csrc/flash_fwd_sm90.cu, csrc/flash_bwd_dq_sm90.cu,
  csrc/flash_bwd_dkv_sm90.cu: wgmma + TMA), fp32 on the CUDA cores
  (csrc/flash_fwd.cu, csrc/flash_bwd.cu). On a CPU tensor their plain
  versions `_flash_fwd_reference` and `_flash_bwd_reference` run. A CUDA tensor
  never falls back to a plain version or to another kernel: the kernel
  launches or the call raises.

Layout at every public function is the JAX package's: [B, S, H, D].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# Launches of each flash kernel (CUDA only; the plain versions on the CPU
# do not count). Reset them to 0 before a run to see which path ran.
flash_fwd_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dkv_launches = 0

_KERNEL_HEAD_DIMS = (32, 64, 128)
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _scale(q, sm_scale):
    return q * (sm_scale if sm_scale is not None else q.shape[-1] ** -0.5)


def mha_reference(q, k, v, causal: bool = True, sm_scale: Optional[float] = None):
    """Plain O(S^2) attention. Shapes: q [B, Sq, H, D], k/v [B, Sk, H, D]."""
    q = _scale(q, sm_scale)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(qi >= ki, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def _block_step(q, kc, vc, acc, m, l, mask=None):
    """One online-softmax accumulation step.

    q [B,Sq,H,D] fp32-scaled; kc/vc [B,Bk,H,D]; acc [B,Sq,H,D] fp32;
    m,l [B,H,Sq] fp32 running max / normalizer. Returns updated (acc,m,l).
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q, kc.float())
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    alpha = torch.exp(m - m_new)
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p.to(vc.dtype), vc).float()
    acc_new = acc * alpha.transpose(1, 2)[..., None] + pv
    return acc_new, m_new, l_new


def blockwise_attention(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None,
                        block_k: int = 512):
    """Memory-efficient attention: loop over KV chunks with online softmax.

    Never materializes the [Sq, Sk] matrix; autograd through the loop
    gives the backward.
    """
    b, sq, h, d = q.shape
    sk = k.shape[1]
    block_k = min(block_k, sk)
    qs = _scale(q, sm_scale).float()
    qi = torch.arange(sq, device=q.device)[:, None]
    acc = q.new_zeros((b, sq, h, d), dtype=torch.float32)
    m = q.new_full((b, h, sq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, sq), dtype=torch.float32)
    for start in range(0, sk, block_k):
        kc, vc = k[:, start:start + block_k], v[:, start:start + block_k]
        mask = None
        if causal:
            ki = start + torch.arange(kc.shape[1], device=q.device)[None, :]
            mask = (qi >= ki)[None, None]
        acc, m, l = _block_step(qs, kc, vc, acc, m, l, mask=mask)
    out = acc / l.clamp_min(1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def gqa_expand(k, v, num_q_heads: int):
    """Expand grouped KV heads to match q heads (GQA → MHA view).

    [B,S,Hkv,D] → [B,S,Hq,D], each KV head repeated for its group of
    query heads. The flash kernel does not need this: it reads KV head
    h // (Hq / Hkv) for query head h directly.
    """
    hkv = k.shape[2]
    if hkv == num_q_heads:
        return k, v
    rep = num_q_heads // hkv
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def _check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be [B, S, H, D]")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree")
    if h % k.shape[2]:
        raise ValueError(f"{h} query heads are not a multiple of "
                         f"{k.shape[2]} KV heads")
    if sq == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must be on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must have one dtype")


def _round_to(x, dtype):
    """x rounded to dtype and back to fp32 (the identity for fp32)."""
    return x if dtype == torch.float32 else x.to(dtype).float()


def _flash_fwd_reference(q, k, v, causal: bool = True,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward kernels: what
    ray_tpu/ops/attention.py::_flash_fwd_kernel computes, in fp32, as one
    softmax over all keys. Returns (O [B,Sq,H,D] in q's dtype,
    LSE [B,H,Sq] fp32 = m + log(max(l, 1e-30))).

    P = exp(s - m) is rounded to the input dtype before P·V, as the
    tensor-core kernel must for bf16 and as the JAX package's
    mha_reference does (`probs.astype(v.dtype)`); l sums the unrounded P.
    In fp32 the rounding is the identity."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qf = q.float() * scale
    kf = k.float().repeat_interleave(h // hkv, dim=2)
    vf = v.float().repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(qi >= ki, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhqk,bkhd->bqhd", _round_to(p, q.dtype), vf) / l.transpose(1, 2)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _check_kernel_inputs(**tensors) -> None:
    """What the Hopper kernels take: fp32 or bf16, head_dim 32/64/128, the
    last dim contiguous (the other dims go by strides)."""
    for name, t in tensors.items():
        if t.dtype not in _KERNEL_DTYPES:
            raise TypeError(f"flash kernel takes float32 or bfloat16, not "
                            f"{t.dtype} ({name})")
        if t.shape[-1] not in _KERNEL_HEAD_DIMS:
            raise ValueError(f"flash kernel takes head_dim in "
                             f"{_KERNEL_HEAD_DIMS}, not {t.shape[-1]}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")


def _check_tma_operands(**tensors) -> None:
    """What the tensor-core kernels' TMA loads take, from each tensor's
    metadata alone: a 16-byte-aligned base address, and batch, sequence
    and head strides that are multiples of 16 bytes and under 2**40 bytes
    (a dim of extent 1 is never stepped over, so its stride is free)."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: TMA needs a 16-byte-aligned base address, "
                             f"not {t.data_ptr():#x}")
        for dim, what in ((0, "batch"), (1, "sequence"), (2, "head")):
            nbytes = t.stride(dim) * t.element_size()
            if t.shape[dim] > 1 and (nbytes % 16 or not 0 < nbytes < 2 ** 40):
                raise ValueError(f"{name}: TMA needs a {what} stride that is a "
                                 f"positive multiple of 16 bytes under 2**40, "
                                 f"not {nbytes} bytes")


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: Optional[float]):
    global flash_fwd_launches
    _check_kernel_inputs(q=q, k=k, v=v)
    from ray_tpu_torch.ops import _build

    b, sq, h, d = q.shape
    scale = sm_scale if sm_scale is not None else d ** -0.5
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    ext = _build.load_extension()
    if q.dtype == torch.bfloat16:  # tensor cores
        _check_tma_operands(q=q, k=k, v=v)
        launch = ext.flash_fwd_sm90
    else:  # fp32: CUDA cores
        launch = ext.flash_fwd
    # launches on the current stream; raises if the launch is refused
    launch(q, k, v, o, lse, float(scale), bool(causal))
    flash_fwd_launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FlashAttention-2 forward: (O [B,Sq,H,D], LSE [B,H,Sq] fp32).

    q [B,Sq,H,D], k/v [B,Sk,Hkv,D] with H a multiple of Hkv. The causal
    mask is top-left aligned (key <= query index) as in the JAX kernel.
    A CUDA tensor runs the Hopper kernel; a CPU tensor the plain version.
    """
    _check_qkv(q, k, v)
    if q.device.type == "cpu":
        return _flash_fwd_reference(q, k, v, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    return _flash_fwd_cuda(q, k, v, causal, sm_scale)


def merge_lse(o_acc, lse_acc, o, lse) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge two attentions of the same queries over disjoint key sets by
    log-sum-exp: ``(o_acc, lse_acc)`` and ``(o, lse)``, O [B,Sq,H,D], LSE
    [B,H,Sq] fp32, give (O fp32, LSE) over the union of the keys. The
    ring (each arriving K/V block) and the paged prefill (the reused
    prefix, then the fresh tokens) both merge this way."""
    new = torch.logaddexp(lse_acc, lse)
    o_acc = (o_acc.float() * torch.exp(lse_acc - new).transpose(1, 2)[..., None]
             + o.float() * torch.exp(lse - new).transpose(1, 2)[..., None])
    return o_acc, new


def _flash_bwd_delta(o, do):
    """Δ = rowsum(dO ∘ O) in fp32, [B, H, Sq]: the softmax-Jacobian term
    both backward passes subtract (the JAX package computes it in jnp
    outside Pallas too, ray_tpu/ops/attention.py:311-316)."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def _flash_bwd_reference(q, k, v, o, lse, do, causal: bool = True,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels: what
    ray_tpu/ops/attention.py::_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel
    compute, in fp32, from the saved O and LSE [B,H,Sq]:

        P  = where(mask, exp(q·scale·Kᵀ − LSE), 0)
        dS = P ∘ (dO·Vᵀ − Δ),  Δ = rowsum(dO ∘ O)
        dQ = scale · dS·K,  dK = dSᵀ·(q·scale),  dV = Pᵀ·dO

    with dK/dV of each KV head summed over its group of query heads.
    P and dS are rounded to the input dtype before the products they
    feed, as the tensor-core kernels must round them for bf16 (the
    identity in fp32). Returns (dQ, dK, dV) in q's, k's and v's dtypes."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    scale = sm_scale if sm_scale is not None else d ** -0.5
    qs = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=2)
    vf = v.float().repeat_interleave(group, dim=2)
    dof = do.float()
    delta = _flash_bwd_delta(o, do)
    s = torch.einsum("bqhd,bkhd->bhqk", qs, kf)
    p = torch.exp(s - lse[..., None])
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None]
        ki = torch.arange(sk, device=q.device)[None, :]
        p = torch.where(qi >= ki, p, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = _round_to(p * (dp - delta[..., None]), q.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs)
    dv = torch.einsum("bhqk,bqhd->bkhd", _round_to(p, q.dtype), dof)
    dk = dk.reshape(b, sk, hkv, group, d).sum(3)
    dv = dv.reshape(b, sk, hkv, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """dQ by the Hopper dQ kernel: bf16 on the tensor cores
    (csrc/flash_bwd_dq_sm90.cu), fp32 on the CUDA cores (csrc/flash_bwd.cu)."""
    global flash_bwd_dq_launches
    from ray_tpu_torch.ops import _build

    dq = torch.empty_like(q, memory_format=torch.contiguous_format)
    ext = _build.load_extension()
    if q.dtype == torch.bfloat16:
        _check_tma_operands(q=q, k=k, v=v, do=do)
        launch = ext.flash_bwd_dq_sm90
    else:
        launch = ext.flash_bwd_dq
    launch(q, k, v, do, lse, delta, dq, float(scale), bool(causal))
    flash_bwd_dq_launches += 1
    return dq


def _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal: bool, scale: float):
    """(dK, dV) by the Hopper dK/dV kernel: bf16 on the tensor cores
    (csrc/flash_bwd_dkv_sm90.cu), fp32 on the CUDA cores (csrc/flash_bwd.cu)."""
    global flash_bwd_dkv_launches
    from ray_tpu_torch.ops import _build

    dk = torch.empty_like(k, memory_format=torch.contiguous_format)
    dv = torch.empty_like(v, memory_format=torch.contiguous_format)
    ext = _build.load_extension()
    if q.dtype == torch.bfloat16:
        _check_tma_operands(q=q, k=k, v=v, do=do)
        launch = ext.flash_bwd_dkv_sm90
    else:
        launch = ext.flash_bwd_dkv
    launch(q, k, v, do, lse, delta, dk, dv, float(scale), bool(causal))
    flash_bwd_dkv_launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        sm_scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FlashAttention-2 backward: (dQ, dK, dV) from the forward's inputs,
    its O and LSE [B,H,Sq] fp32, and dO = dL/dO [B,Sq,H,D].

    A CUDA tensor runs the dQ kernel and the dK/dV kernel; a CPU tensor
    the plain version. dK/dV hold each KV head's sum over its group."""
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"match q {tuple(q.shape)}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be [B, H, Sq] = {(b, h, sq)} float32, "
                         f"not {tuple(lse.shape)} {lse.dtype}")
    if not all(t.device == q.device for t in (o, lse, do)):
        raise ValueError("o, lse and do must be on q's device")
    if q.device.type == "cpu":
        return _flash_bwd_reference(q, k, v, o, lse, do, causal, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"no flash attention for device {q.device}")
    _check_kernel_inputs(q=q, k=k, v=v, do=do)
    if do.dtype != q.dtype:
        raise TypeError(f"do is {do.dtype}, q is {q.dtype}")
    scale = sm_scale if sm_scale is not None else d ** -0.5
    lse = lse.contiguous()
    delta = _flash_bwd_delta(o, do)
    dq = _flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal, scale)
    dk, dv = _flash_bwd_dkv_cuda(q, k, v, do, lse, delta, causal, scale)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        if g.stride(-1) != 1:  # autograd may hand over any layout
            g = g.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, g, ctx.causal,
                                         ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = 256, block_k: int = 512):
    """Fused attention, [B,Sq,H,D] x [B,Sk,Hkv,D] → [B,Sq,H,D].

    `block_q`/`block_k` are the JAX signature's TPU tile sizes; the Hopper
    kernel picks its own tiles, so they do not change the result."""
    del block_q, block_k
    return _FlashAttention.apply(q, k, v, causal, sm_scale)
