"""Flagship model family: Llama-style decoder-only transformer (PyTorch
port of ray_tpu/models/transformer.py, dense path).

Plain functions on tensors: a model is (config, params dict, forward).
The params keep the JAX package's layout — layer leaves STACKED on a
leading ``layers`` dim, ``wq [L, h, nh, hd]``, ``wo [L, nh, hd, h]`` — so
weights convert one to one and tests compare like with like. The layer
stack runs as a Python loop over ``t[i]`` of each stacked leaf; a caller
may hand in a list of per-layer tensors in place of a stacked leaf, as
the train step does (ray_tpu_torch/train/step.py). Under autograd, with
``cfg.remat``, each block runs under ``torch.utils.checkpoint``.

Not in this slice (each raises NotImplementedError naming its ROADMAP
row): mixture-of-experts and pipeline/sharded meshes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import default_device
from ray_tpu_torch.ops.attention import flash_attention

Params = Dict[str, Any]

_MOE_TODO = ("mixture-of-experts is not ported yet "
             "(ROADMAP.md Queue A, 'MoE, pipeline, ring attention, sharding')")


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
    num_experts: int = 0  # > 0 (mixture-of-experts) is not ported yet

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
        heads=32, kv_heads=8, max_seq=8192, rope_theta=1e6, num_experts=8,
    ),
    "moe_debug": TransformerConfig(
        vocab_size=512, hidden=128, mlp_hidden=256, layers=2, heads=4,
        kv_heads=2, max_seq=128, remat=False, num_experts=4,
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
    and 0 for a LoRA B (zeros). Layer leaves are STACKED on ``layers``."""
    if cfg.num_experts:
        raise NotImplementedError(_MOE_TODO)
    h, m, v, l = cfg.hidden, cfg.mlp_hidden, cfg.vocab_size, cfg.layers
    hd, nh, nkv = cfg.hd, cfg.heads, cfg.kv_heads
    shapes: Params = {
        "embed": ((v, h), h),  # scaled like the output projection
        "blocks": {
            "wq": ((l, h, nh, hd), h),
            "wk": ((l, h, nkv, hd), h),
            "wv": ((l, h, nkv, hd), h),
            "wo": ((l, nh, hd, h), nh * hd),
            "ln_attn": ((l, h), None),
            "ln_mlp": ((l, h), None),
            "wi_gate": ((l, h, m), h),
            "wi_up": ((l, h, m), h),
            "wo_mlp": ((l, m, h), m),
        },
        "ln_f": ((h,), None),
    }
    if not cfg.tie_embeddings:
        shapes["unembed"] = ((h, v), h)
    if cfg.lora_rank:
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


def _mlp(cfg: TransformerConfig, x, p, lora):
    """Second half of a block: x + SwiGLU(RMSNorm(x))."""
    y = _rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    gate = torch.einsum("bsh,hm->bsm", y, p["wi_gate"].to(y.dtype))
    up = torch.einsum("bsh,hm->bsm", y, p["wi_up"].to(y.dtype))
    if lora is not None:
        gate = gate + _lora_delta(y, lora["wi_a"], lora["wi_b"],
                                  cfg.lora_alpha / cfg.lora_rank)
    act = F.silu(gate) * up
    return x + torch.einsum("bsm,mh->bsh", act, p["wo_mlp"].to(act.dtype))


def _block(cfg: TransformerConfig, x, layer_params, lora_params, positions,
           attn_fn):
    """One decoder block. x [B,S,H_emb] in compute dtype."""
    p = layer_params
    y = _rms_norm(x, p["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(cfg, y, p, lora_params, positions)
    attn = attn_fn(q, k, v)
    x = x + torch.einsum("bsnd,ndh->bsh", attn, p["wo"].to(attn.dtype))
    return _mlp(cfg, x, p, lora_params)


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
    if cfg.num_experts:
        raise NotImplementedError(_MOE_TODO)
    if mesh is not None or num_microbatches is not None:
        raise NotImplementedError(
            "meshes and pipeline stages are not ported yet (ROADMAP.md "
            "Queue A, 'MoE, pipeline, ring attention, sharding')")
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
