"""Attention ops, GPU-first (PyTorch port of ray_tpu/ops/attention.py).

Three tiers, all the same math (softmax(QK^T * scale + mask) V):

- `mha_reference`   : plain torch, O(S^2) memory — ground truth for tests.
- `blockwise_attention` : online softmax over KV chunks in a Python loop —
  O(S * block) memory, differentiable by autograd.
- `flash_attention` : the FlashAttention-2 forward kernel written for
  Hopper (csrc/flash_fwd.cu) on a CUDA tensor; its plain version
  `_flash_fwd_reference` on a CPU tensor. A CUDA tensor never falls back
  to the plain version: the kernel launches or the call raises.

Layout at every public function is the JAX package's: [B, S, H, D].
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30

# Launches of the flash forward kernel (CUDA only; the plain version on the
# CPU does not count). Reset it to 0 before a run to see which path ran.
flash_fwd_launches = 0

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


def _flash_fwd_reference(q, k, v, causal: bool = True,
                         sm_scale: Optional[float] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the flash forward kernel: what
    ray_tpu/ops/attention.py::_flash_fwd_kernel computes, in fp32, as one
    softmax over all keys. Returns (O [B,Sq,H,D] in q's dtype,
    LSE [B,H,Sq] fp32 = m + log(max(l, 1e-30)))."""
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
    o = torch.einsum("bhqk,bkhd->bqhd", p, vf) / l.transpose(1, 2)
    lse = (m + torch.log(l))[..., 0]
    return o.to(q.dtype), lse


def _flash_fwd_cuda(q, k, v, causal: bool, sm_scale: Optional[float]):
    global flash_fwd_launches
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"flash kernel takes float32 or bfloat16, not {q.dtype}")
    b, sq, h, d = q.shape
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {_KERNEL_HEAD_DIMS}, not {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must be contiguous in its last dim")
    from ray_tpu_torch.ops import _build

    scale = sm_scale if sm_scale is not None else d ** -0.5
    o = torch.empty_like(q, memory_format=torch.contiguous_format)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    # launches on the current stream; raises if the launch is refused
    _build.load_extension().flash_fwd(q, k, v, o, lse, float(scale), bool(causal))
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


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        o, _ = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        if q.device.type != "cpu":
            raise NotImplementedError(
                "flash attention backward on CUDA is the training slice "
                "(ROADMAP.md Queue A, 'Training slice': kernels "
                "_flash_bwd_dq_kernel and _flash_bwd_dkv_kernel)")
        # CPU: differentiate the plain version (recomputed), as the JAX
        # package differentiates its blockwise fallback off the TPU
        with torch.enable_grad():
            qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
            o, _ = _flash_fwd_reference(qq, kk, vv, ctx.causal, ctx.sm_scale)
            dq, dk, dv = torch.autograd.grad(o, (qq, kk, vv), g)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: Optional[float] = None,
                    block_q: int = 256, block_k: int = 512):
    """Fused attention, [B,Sq,H,D] x [B,Sk,Hkv,D] → [B,Sq,H,D].

    `block_q`/`block_k` are the JAX signature's TPU tile sizes; the Hopper
    kernel picks its own tiles, so they do not change the result."""
    del block_q, block_k
    return _FlashAttention.apply(q, k, v, causal, sm_scale)
