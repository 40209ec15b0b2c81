"""Ring attention — exact attention over sequence shards (PyTorch port of
ray_tpu/ops/ring_attention.py).

The sequence is cut over a process group (the mesh's ``sequence`` axis):
rank ``i`` of ``n`` holds global positions ``[i*S_local, (i+1)*S_local)``
of q, k and v. Q stays put; the K/V blocks go round the ring, each rank
sending to the next and receiving from the previous, so at step ``t``
rank ``my`` holds the block of rank ``(my - t) % n``. The causal mask is
by global position.

Each step is a call of the port's flash kernels on the block, not JAX's
XLA ``_block_step`` ("ring flash attention"). For the block from rank
``src`` under the causal mask: ``src == my`` is the diagonal block
(``causal=True``), ``src < my`` is wholly visible (``causal=False``), and
``src > my`` is wholly masked, so nothing is launched (JAX computes it
and masks it away: the same answer). Without the mask every block is
visible. Each step's (O, LSE) is merged into fp32 accumulators by
log-sum-exp. The backward runs a second ring: each rank calls the flash
backward on each visible block with the *global* O and LSE (so P is the
block's share of the global softmax and Δ = rowsum(dO∘O) the global
one); the dK/dV accumulators, fp32, travel with their K/V block and end
on its owner.

GQA: K/V go round un-expanded (``kv_heads``); the kernels map query head
``h`` to KV head ``h // (heads / kv_heads)`` themselves, the function
JAX's ``gqa_expand``-then-ring computes with 1/G of the bytes.

The per-rank loops (``ring_attention_rank_fwd``, ``ring_attention_rank_bwd``)
take the blocks in the order they arrive, with their source ranks; the
P2P transport (``ring_attention``) is a thin layer that feeds them from
``batch_isend_irecv``. A caller can feed them every rank's blocks on one
device instead, as chip_smoke.py and the tests do. The forward sends
each rank's K/V n − 1 times, never the last, dead rotation (as JAX's
:85-89); the backward sends K/V n − 1 times and the dK/dV accumulators
n times (the last send brings each block's grads home).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import (
    flash_attention, flash_attention_bwd, flash_attention_fwd, merge_lse,
)
from ray_tpu_torch.parallel.collectives import exchange


def _visible(src: int, my: int, causal: bool) -> Tuple[bool, bool]:
    """(whether rank ``my``'s queries see any key of rank ``src``'s block,
    whether the block needs the causal mask)."""
    if not causal:
        return True, False
    return src <= my, src == my


def ring_attention_rank_fwd(q, blocks: Iterable, my: int, causal: bool = True,
                            sm_scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rank ``my``'s forward: its queries ``q`` [B, S_local, H, D] against
    ``blocks``, an iterable of ``(k, v, src)`` (k/v [B, S_local, Hkv, D]
    from rank ``src``) in the order they arrive, every rank's block once.
    Returns (O in q's dtype, LSE [B, H, S_local] fp32) over all of them."""
    o_acc = lse_acc = None
    for k, v, src in blocks:
        see, mask = _visible(src, my, causal)
        if not see:
            continue
        o, lse = flash_attention_fwd(q, k, v, causal=mask, sm_scale=sm_scale)
        if o_acc is None:
            o_acc, lse_acc = o.float(), lse
            continue
        o_acc, lse_acc = merge_lse(o_acc, lse_acc, o, lse)
    return o_acc.to(q.dtype), lse_acc


def ring_attention_rank_bwd(q, o, lse, do, blocks: Iterable, my: int,
                            causal: bool = True, sm_scale: Optional[float] = None
                            ) -> torch.Tensor:
    """Rank ``my``'s backward: ``o``, ``lse`` are its global forward
    outputs, ``do`` the grad of ``o``; ``blocks`` an iterable of ``(k, v,
    src, dk, dv)`` in the order they arrive, where ``dk``, ``dv`` are the
    block's fp32 accumulators: this rank's share of the grads of k and v
    is added into them in place. Returns dQ in q's dtype."""
    dq = None
    for k, v, src, dk, dv in blocks:
        see, mask = _visible(src, my, causal)
        if not see:
            continue
        dq_b, dk_b, dv_b = flash_attention_bwd(q, k, v, o, lse, do, causal=mask,
                                               sm_scale=sm_scale)
        dq = dq_b.float() if dq is None else dq.add_(dq_b)
        dk.add_(dk_b)
        dv.add_(dv_b)
    return dq.to(q.dtype)


def _fwd_ring(k, v, group):
    """The forward's blocks, ``(k, v, src)``: the next block is received
    while the caller computes on the current one; the last is not sent
    on."""
    n, my = dist.get_world_size(group), dist.get_rank(group)
    cur = (k, v)
    for t in range(n):
        reqs, nxt = [], None
        if t < n - 1:
            nxt = (torch.empty_like(k), torch.empty_like(v))
            reqs = exchange(list(cur), list(nxt), group)
        yield cur[0], cur[1], (my - t) % n
        for r in reqs:
            r.wait()
        cur = nxt


class _BwdRing:
    """The backward's blocks, ``(k, v, src, dk, dv)``. K/V are received
    while the caller computes; once the caller is done with a block its
    accumulators go to the next rank, and the previous rank's come in
    for the next block. After the last block the accumulators make one
    more step, home to the block's owner: ``dk``, ``dv`` then hold the
    grads of this rank's own k and v."""

    def __init__(self, k, v, group):
        self.k, self.v, self.group = k, v, group
        self.dk = self.dv = None

    def __iter__(self):
        n, my, group = dist.get_world_size(self.group), dist.get_rank(self.group), self.group
        kv = (self.k, self.v)
        acc = (torch.zeros_like(self.k, dtype=torch.float32),
               torch.zeros_like(self.v, dtype=torch.float32))
        for t in range(n):
            kv_reqs, nxt = [], None
            if t < n - 1:
                nxt = (torch.empty_like(self.k), torch.empty_like(self.v))
                kv_reqs = exchange(list(kv), list(nxt), group)
            yield kv[0], kv[1], (my - t) % n, acc[0], acc[1]
            came = (torch.empty_like(acc[0]), torch.empty_like(acc[1]))
            for r in exchange(list(acc), list(came), group) + kv_reqs:
                r.wait()
            kv, acc = nxt, came
        self.dk, self.dv = acc


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, sm_scale):
        k, v = k.contiguous(), v.contiguous()
        my = dist.get_rank(group)
        o, lse = ring_attention_rank_fwd(q, _fwd_ring(k, v, group), my, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.group, ctx.causal, ctx.sm_scale = group, causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring = _BwdRing(k, v, ctx.group)
        dq = ring_attention_rank_bwd(q, o, lse, do.contiguous(), ring,
                                     dist.get_rank(ctx.group), ctx.causal, ctx.sm_scale)
        return dq, ring.dk.to(k.dtype), ring.dv.to(v.dtype), None, None, None


def ring_attention(q, k, v, group, causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Exact attention with q/k/v cut over ``group`` along the sequence
    (contiguous shards in group-rank order): q [B, S_local, H, D], k/v
    [B, S_local, Hkv, D] → [B, S_local, H, D]. Differentiable. Where JAX
    binds the ring by an axis name under shard_map, the port takes the
    process group. At one rank (or ``group`` None) it is
    ``flash_attention``, as JAX's is its unsharded blockwise attention."""
    if group is None or dist.get_world_size(group) == 1:
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return _RingAttention.apply(q, k, v, group, causal, sm_scale)


__all__ = ["ring_attention", "ring_attention_rank_fwd", "ring_attention_rank_bwd"]
