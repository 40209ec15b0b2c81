"""Flagship model family: Llama-style decoder-only transformer (PyTorch
port of ray_tpu/models/transformer.py: dense and mixture-of-experts).

Plain functions on tensors: a model is (config, params dict, forward).
The params keep the JAX package's layout — layer leaves STACKED on a
leading ``layers`` dim, ``wq [L, h, nh, hd]``, ``wo [L, nh, hd, h]`` — so
weights convert one to one and tests compare like with like. The layer
stack runs as a Python loop over ``t[i]`` of each stacked leaf; a caller
may hand in a list of per-layer tensors in place of a stacked leaf, as
the train step does (ray_tpu_torch/train/step.py). Under autograd, with
``cfg.remat``, each block runs under ``torch.utils.checkpoint``.

A mixture-of-experts MLP (``num_experts > 0``) routes as the JAX
package's ``_moe_mlp`` does (top-k token choice, choice-major capacity
drop) but dispatches by index: the kept tokens are gathered into an
``[E, C, h]`` buffer and the expert outputs gathered back, where JAX
multiplies by one-hot ``[k·T, E, C]`` tensors (see ``_moe_mlp``).

Not in this slice (raises NotImplementedError naming its ROADMAP row):
pipeline and sharded meshes, expert parallelism among them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import default_device
from ray_tpu_torch.ops.attention import flash_attention

Params = Dict[str, Any]

_MESH_TODO = ("meshes and pipeline stages are not ported yet (ROADMAP.md "
              "Queue A item 3: pipeline, ring attention, sharding and expert "
              "parallelism, the next slice)")


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Hyperparameters for the Llama family."""

    vocab_size: int = 32000
    hidden: int = 4096
    mlp_hidden: int = 11008
    layers: int = 32
    heads: int = 32
    kv_heads: int = 32
    head_dim: Optional[int] = None  # default hidden // heads
    max_seq: int = 4096
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32  # master weights
    remat: bool = True  # recompute each block in the backward (checkpoint)
    lora_rank: int = 0  # 0 = dense; >0 = LoRA adapters on q, v and gate
    lora_alpha: float = 16.0
    # Mixture-of-experts (0 = dense MLP): top-k token choice with a
    # capacity of capacity_factor * tokens * k / experts slots per expert
    num_experts: int = 0
    experts_per_token: int = 2
    capacity_factor: float = 1.25

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden // self.heads

    def flops_per_token(self) -> float:
        """Approx forward+backward FLOPs/token (6*N + attention), for MFU."""
        n_params = self.num_params()
        attn = 12 * self.layers * self.hidden * self.max_seq  # rough
        return 6 * n_params + attn

    def num_params(self) -> int:
        h, m, l, v = self.hidden, self.mlp_hidden, self.layers, self.vocab_size
        hd, nh, nkv = self.hd, self.heads, self.kv_heads
        mlp = 3 * h * m
        if self.num_experts:
            mlp = self.num_experts * 3 * h * m + h * self.num_experts  # + router
        per_layer = h * (nh * hd) + 2 * h * (nkv * hd) + (nh * hd) * h + mlp + 2 * h
        emb = v * h * (1 if self.tie_embeddings else 2)
        return l * per_layer + emb + h


PRESETS: Dict[str, TransformerConfig] = {
    "debug": TransformerConfig(
        vocab_size=512, hidden=128, mlp_hidden=352, layers=2, heads=4,
        kv_heads=2, max_seq=128, remat=False,
    ),
    "tiny": TransformerConfig(
        vocab_size=2048, hidden=256, mlp_hidden=704, layers=4, heads=8,
        kv_heads=4, max_seq=512,
    ),
    "llama2_7b": TransformerConfig(),
    "llama2_7b_lora": TransformerConfig(lora_rank=16),
    "llama3_8b": TransformerConfig(
        vocab_size=128256, hidden=4096, mlp_hidden=14336, layers=32,
        heads=32, kv_heads=8, max_seq=8192, rope_theta=500000.0,
    ),
    "mixtral_8x7b": TransformerConfig(
        vocab_size=32000, hidden=4096, mlp_hidden=14336, layers=32,
        heads=32, kv_heads=8, max_seq=8192, rope_theta=1e6,
        num_experts=8, experts_per_token=2,
    ),
    "moe_debug": TransformerConfig(
        vocab_size=512, hidden=128, mlp_hidden=256, layers=2, heads=4,
        kv_heads=2, max_seq=128, remat=False, num_experts=4,
        experts_per_token=2,
    ),
}


def config(name_or_cfg, **overrides) -> TransformerConfig:
    cfg = PRESETS[name_or_cfg] if isinstance(name_or_cfg, str) else name_or_cfg
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


# ---------------------------------------------------------------------------
# Parameter init
# ---------------------------------------------------------------------------

def param_shapes(cfg: TransformerConfig) -> Params:
    """The params dict's structure with ``(shape, fan_in)`` leaves:
    ``fan_in`` is the normal init's scale, None for a norm weight (ones)
    and 0 for a LoRA B (zeros). Layer leaves are STACKED on ``layers``;
    a MoE config's expert leaves carry the experts next, ``[L, E, ...]``."""
    h, m, v, l = cfg.hidden, cfg.mlp_hidden, cfg.vocab_size, cfg.layers
    hd, nh, nkv = cfg.hd, cfg.heads, cfg.kv_heads
    ex = (cfg.num_experts,) if cfg.num_experts else ()
    blocks: Params = {
        "wq": ((l, h, nh, hd), h),
        "wk": ((l, h, nkv, hd), h),
        "wv": ((l, h, nkv, hd), h),
        "wo": ((l, nh, hd, h), nh * hd),
        "ln_attn": ((l, h), None),
        "ln_mlp": ((l, h), None),
        "wi_gate": ((l, *ex, h, m), h),
        "wi_up": ((l, *ex, h, m), h),
        "wo_mlp": ((l, *ex, m, h), m),
    }
    if cfg.num_experts:
        blocks["router"] = ((l, h, cfg.num_experts), h)
    shapes: Params = {
        "embed": ((v, h), h),  # scaled like the output projection
        "blocks": blocks,
        "ln_f": ((h,), None),
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = ((h, v), h)
    if cfg.lora_rank:  # with MoE too: JAX makes wi_a/wi_b, _moe_mlp never reads them
        r = cfg.lora_rank
        shapes["lora"] = {
            "wq_a": ((l, h, r), h), "wq_b": ((l, r, nh * hd), 0),
            "wv_a": ((l, h, r), h), "wv_b": ((l, r, nkv * hd), 0),
            "wi_a": ((l, h, r), h), "wi_b": ((l, r, m), 0),
        }
    return shapes


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """Initialize the parameter dict: the JAX package's shapes and
    ``normal / sqrt(fan_in)`` scale, drawn from ``generator`` (torch draws
    other numbers than jax.random from the same seed; tests convert the
    JAX init with models/convert.py instead). Stacked leaves are filled
    one layer at a time, so only one layer's fp32 draw is alive beside
    the params."""
    device = default_device(device)
    pd = cfg.param_dtype

    def init(spec):
        if isinstance(spec, dict):
            return {k: init(s) for k, s in spec.items()}
        shape, fan_in = spec
        if fan_in is None:
            return torch.ones(shape, dtype=pd, device=device)
        out = torch.zeros(shape, dtype=pd, device=device)
        if fan_in:
            # the drawn leaves of 3+ dims are layer-stacked: one draw per layer
            for part in (out if len(shape) > 2 else [out]):
                x = torch.randn(part.shape, generator=generator,
                                dtype=torch.float32, device=generator.device)
                part.copy_(x / math.sqrt(fan_in))
        return out

    return init(param_shapes(cfg))


def _layer(params: Params, i: int):
    """Layer ``i``'s block params and LoRA params (or None): ``t[i]`` of
    each leaf, a view of a stacked leaf or an item of a per-layer list."""
    lp = {k: t[i] for k, t in params["blocks"].items()}
    lora = params.get("lora")
    return lp, (None if lora is None else {k: t[i] for k, t in lora.items()})


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _rms_norm(x, w, eps):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * w.to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding on split halves. x [B,S,H,D], positions [B,S] or [S]."""
    d = x.shape[-1]
    # a Python-float base: a device tensor made from theta would cost a
    # host-to-device copy (a stream sync) per call
    freqs = torch.pow(theta, -torch.arange(0, d // 2, dtype=torch.float32,
                                           device=x.device) / (d // 2))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B,S,D/2]
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _lora_delta(x, a, b, scale):
    return torch.einsum("bsh,hr->bsr", x, a.to(x.dtype)) @ b.to(x.dtype) * scale


def _qkv(cfg: TransformerConfig, y, p, lora, positions):
    """Projections + LoRA + RoPE shared by _block and the cached block.
    Returns q [B,S,nh,hd], k/v [B,S,nkv,hd]."""
    b, s, _ = y.shape
    nh, nkv, hd = cfg.heads, cfg.kv_heads, cfg.hd
    q = torch.einsum("bsh,hnd->bsnd", y, p["wq"].to(y.dtype))
    k = torch.einsum("bsh,hnd->bsnd", y, p["wk"].to(y.dtype))
    v = torch.einsum("bsh,hnd->bsnd", y, p["wv"].to(y.dtype))
    if lora is not None:
        scale = cfg.lora_alpha / cfg.lora_rank
        q = q + _lora_delta(y, lora["wq_a"], lora["wq_b"], scale).reshape(b, s, nh, hd)
        v = v + _lora_delta(y, lora["wv_a"], lora["wv_b"], scale).reshape(b, s, nkv, hd)
    return _rope(q, positions, cfg.rope_theta), _rope(k, positions, cfg.rope_theta), v


class MoeRouting(NamedTuple):
    """How ``moe_routing`` places T tokens. Entries are choice-major:
    entry ``p = choice * T + token``."""

    gate_idx: torch.Tensor  # [T, k] int64: each token's experts, best first
    gate_vals: torch.Tensor  # [T, k] fp32: their gates, renormalised over k
    slot: torch.Tensor  # [k*T] int64: each entry's slot in its expert
    keep: torch.Tensor  # [k*T] bool: slot < capacity (else dropped)
    capacity: int  # slots per expert


def moe_capacity(cfg: TransformerConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` tokens, as the JAX package computes
    it (a Python float product, truncated)."""
    return max(4, int(cfg.capacity_factor * tokens * cfg.experts_per_token
                      / cfg.num_experts))


def moe_routing(cfg: TransformerConfig, x, router) -> MoeRouting:
    """Top-k token-choice routing of ``x`` [T, h] by ``router`` [h, E]:
    fp32 logits and softmax, the k best experts (sorted, as lax.top_k),
    their gates renormalised. Slots are given in choice-major order, so
    every token's first choice is placed before any second choice; an
    entry past its expert's capacity is dropped, and the gates are not
    renormalised after a drop."""
    t = x.shape[0]
    e, k = cfg.num_experts, cfg.experts_per_token
    probs = torch.softmax(x.float() @ router.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    idx = gate_idx.T.reshape(k * t)
    # an entry's slot: how many entries before it chose its expert, by a
    # scan of the [E, k·T] one-hot along its inner dim
    onehot = idx[None, :] == torch.arange(e, device=x.device)[:, None]
    slot = onehot.cumsum(1).gather(0, idx[None, :])[0] - 1
    cap = moe_capacity(cfg, t)
    return MoeRouting(gate_idx, gate_vals, slot, slot < cap, cap)


def _expert_ffn(xe, p):
    """Each expert's SwiGLU on its rows: ``xe`` [E, C, h] in the compute
    dtype, three batched products over E."""
    gate = torch.bmm(xe, p["wi_gate"].to(xe.dtype))
    up = torch.bmm(xe, p["wi_up"].to(xe.dtype))
    return torch.bmm(F.silu(gate) * up, p["wo_mlp"].to(xe.dtype))


def _moe_mlp(cfg: TransformerConfig, y, p):
    """Top-k token-choice mixture of experts with capacity drop: the
    function of the JAX package's ``_moe_mlp``. JAX builds one-hot
    dispatch and combine tensors ``[k·T, E, C]`` and contracts them
    (GSPMD partitions those einsums on the expert axis); here each kept
    entry is copied into its (expert, slot) row of an ``[E, C, h]``
    buffer, which receives at most one token per row, and the expert
    outputs are copied back and scaled by the gate, cast to the
    compute dtype first as JAX casts ``combine``. Empty slots stay zero;
    a dropped entry adds 0.

    Both moves are ``index_copy`` with distinct destinations, so their
    backward is a gather (``index_select``): no scatter-add, and grads
    are deterministic. Copies with no real destination (a dropped entry,
    an empty slot) go to one spare last row, which is cut off."""
    b, s, h = y.shape
    t, e, k = b * s, cfg.num_experts, cfg.experts_per_token
    x = y.reshape(t, h)
    r = moe_routing(cfg, x, p["router"])
    cap = r.capacity
    # each entry's row in the [E*C] buffer, or the spare row if dropped
    row = torch.where(r.keep, r.gate_idx.T.reshape(k * t) * cap + r.slot, e * cap)
    xe = x.new_zeros(e * cap + 1, h).index_copy(0, row, x.repeat(k, 1))
    out_e = _expert_ffn(xe[:-1].view(e, cap, h), p).view(e * cap, h)
    # each buffer row's entry, or the spare entry if no entry landed there
    entry = torch.full((e * cap + 1,), k * t, dtype=torch.long, device=x.device)
    entry = entry.scatter(0, row, torch.arange(k * t, device=x.device))[:-1]
    yk = out_e.new_zeros(k * t + 1, h).index_copy(0, entry, out_e)[:-1]
    yk = yk * r.gate_vals.T.reshape(k * t).to(y.dtype)[:, None]
    return yk.view(k, t, h).sum(0).view(b, s, h)


def _mlp(cfg: TransformerConfig, x, p, lora):
    """Second half of a block: x + SwiGLU(RMSNorm(x)), or the mixture of
    experts for a MoE config (which, as in JAX, reads no LoRA adapter)."""
    y = _rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if cfg.num_experts:
        return x + _moe_mlp(cfg, y, p)
    gate = torch.einsum("bsh,hm->bsm", y, p["wi_gate"].to(y.dtype))
    up = torch.einsum("bsh,hm->bsm", y, p["wi_up"].to(y.dtype))
    if lora is not None:
        gate = gate + _lora_delta(y, lora["wi_a"], lora["wi_b"],
                                  cfg.lora_alpha / cfg.lora_rank)
    act = F.silu(gate) * up
    return x + torch.einsum("bsm,mh->bsh", act, p["wo_mlp"].to(act.dtype))


def _attention(cfg: TransformerConfig, x, p, lora, positions, attn_fn):
    """First half of a block: x + attention(RMSNorm(x))."""
    y = _rms_norm(x, p["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(cfg, y, p, lora, positions)
    attn = attn_fn(q, k, v)
    return x + torch.einsum("bsnd,ndh->bsh", attn, p["wo"].to(attn.dtype))


def _block(cfg: TransformerConfig, x, layer_params, lora_params, positions,
           attn_fn):
    """One decoder block. x [B,S,H_emb] in compute dtype."""
    x = _attention(cfg, x, layer_params, lora_params, positions, attn_fn)
    return _mlp(cfg, x, layer_params, lora_params)


def _default_attn(cfg: TransformerConfig):
    # no gqa_expand: the flash kernel maps query head h to KV head
    # h // (heads / kv_heads) itself, which is the same function
    def attn(q, k, v):
        return flash_attention(q, k, v, causal=True)
    return attn


def _logits(cfg: TransformerConfig, params: Params, x):
    """Final norm + vocabulary projection: x [B,S,h] → logits [B,S,V]."""
    x = _rms_norm(x, params["ln_f"], cfg.norm_eps)
    w = params.get("unembed")
    if w is None:
        w = params["embed"].T
    return torch.einsum("bsh,hv->bsv", x, w.to(x.dtype))


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            attn_fn=None, mesh=None,
            num_microbatches: Optional[int] = None) -> torch.Tensor:
    """tokens [B,S] int → logits [B,S,V] (compute dtype).

    ``attn_fn(q,k,v)->o`` overrides attention. ``mesh`` (pipeline or
    sharded layer stacks) is not ported yet and raises."""
    if mesh is not None or num_microbatches is not None:
        raise NotImplementedError(_MESH_TODO)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    attn_fn = attn_fn or _default_attn(cfg)
    # Full per-block remat, as the JAX package's jax.checkpoint: the
    # backward re-runs each block from its input. A selective policy that
    # kept the attention output would not help: the flash backward needs
    # the LSE, which only the re-run forward kernel produces.
    remat = cfg.remat and torch.is_grad_enabled()
    x = params["embed"].to(cfg.dtype)[tokens]
    for i in range(cfg.layers):
        lp, lo = _layer(params, i)
        if remat:
            x = checkpoint(_block, cfg, x, lp, lo, positions, attn_fn,
                           use_reentrant=False, preserve_rng_state=False)
        else:
            x = _block(cfg, x, lp, lo, positions, attn_fn)
    return _logits(cfg, params, x)


def loss_fn(cfg: TransformerConfig, params: Params, batch, attn_fn=None,
            mesh=None, num_microbatches: Optional[int] = None):
    """Next-token cross-entropy. batch: tokens [B,S] int, optional
    loss_mask [B,S]. Returns (loss, {"loss", "accuracy", "tokens"}), all
    0-dim fp32 tensors on the tokens' device (no host sync)."""
    tokens = batch["tokens"]
    # Forward over the FULL sequence (as the JAX package, whose sequence
    # shards must keep S divisible by the mesh axis); shift at the logits.
    logits = forward(cfg, params, tokens, attn_fn=attn_fn, mesh=mesh,
                     num_microbatches=num_microbatches)[:, :-1].float()
    targets = tokens[:, 1:].long()
    logz = torch.logsumexp(logits, dim=-1)
    tgt_logit = torch.take_along_dim(logits, targets[..., None], dim=-1)[..., 0]
    nll = logz - tgt_logit
    acc = (logits.argmax(-1) == targets).float()
    mask = batch.get("loss_mask")
    if mask is not None:
        mask = mask[:, 1:].float()
        denom = mask.sum().clamp_min(1.0)
        loss = (nll * mask).sum() / denom
        acc = (acc * mask).sum() / denom
    else:
        # a fill, not a host-to-device copy (which would sync the stream)
        denom = torch.full((), float(nll.numel()), device=nll.device)
        loss = nll.mean()
        acc = acc.mean()
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def trainable_mask(cfg: TransformerConfig, params: Params) -> Params:
    """True where a param trains: everything for dense, only adapters for
    LoRA (the reference's LoRA target trains adapters only)."""
    def mark(tree, trains):
        if isinstance(tree, dict):
            return {k: mark(t, trains or k == "lora") for k, t in tree.items()}
        return trains
    return mark(params, not cfg.lora_rank)


def trainable_leaves(cfg: TransformerConfig, tree: Params) -> Params:
    """The part of a params-shaped ``tree`` that trains: all of it for
    dense, ``{"lora": ...}`` for LoRA. The layout of the optimizer's
    moments (ray_tpu_torch/train/step.py)."""
    return {"lora": tree["lora"]} if cfg.lora_rank else tree
