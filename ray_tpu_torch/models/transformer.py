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

Under a mesh (a DeviceMesh from ray_tpu_torch.parallel.build_mesh) the
model runs on this rank's part of the batch and its shards of the
params, placed as ``param_axes`` and the JAX package's DEFAULT_RULES
place them; the collectives JAX's GSPMD program derives are written out
(ray_tpu_torch/parallel/collectives.py):

- data (replica, data, fsdp): the batch rows are cut; the loss divides
  by the global mask sum;
- sequence: the tokens are cut along S; attention is ring attention
  (ray_tpu_torch/ops/ring_attention.py), RoPE takes global positions,
  and each shard's last target is the next shard's first token;
- fsdp (ZeRO-3): each leaf's ``embed`` dim is cut; a layer gathers its
  leaves before use (``gather_dim``, whose backward reduce-scatters the
  grads), in the remat re-run too;
- tensor (Megatron): ``wq``/``wk``/``wv``/``wi_*`` and LoRA's B are cut
  on their output dim (heads, kv_heads, mlp), ``wo``/``wo_mlp`` on their
  input dim, the embedding and unembedding over the vocabulary: the
  lookup is masked to the rank's rows and summed, the loss takes a
  distributed log-sum-exp, target logit and argmax;
- expert: a MoE layer routes over the gathered tokens of the batch and
  sequence groups (the global batch, or under a pipeline the global
  microbatch) and sums its local experts' outputs over the expert and
  tensor groups (each rank holds its experts' cut of ``mlp``);
- stage: the layer stack runs as a GPipe pipeline of M microbatches
  (ray_tpu_torch/ops/pipeline.py), each stage on its own layers; the
  embedding, the final norm and the loss run on every stage, and the
  loss counts on the last stage only.

The mesh path issues its collectives whatever the axes' sizes. A MoE
config under ``stage`` and ``sequence`` both above 1 raises
NotImplementedError naming its ROADMAP row (``check_mesh``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch import default_device
from ray_tpu_torch.ops.attention import flash_attention
from ray_tpu_torch.ops.pipeline import pipelined_layers
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.collectives import (
    NO_MESH, MeshGroups, gather_dim, gather_rows, max_over, mesh_groups, min_over,
    sum_grads, sum_partials,
)
from ray_tpu_torch.parallel.mesh import mesh_axis_size
from ray_tpu_torch.parallel.sharding import axis_dim

Params = Dict[str, Any]

# what the port does not take, by the ROADMAP.md row that says why
_MOE_PP_SP = "Queue C, MoE under stage and sequence"


def check_mesh(mesh, num_microbatches: Optional[int] = None,
               cfg: Optional["TransformerConfig"] = None, stages: int = 1) -> MeshGroups:
    """The groups the model's collectives run on under ``mesh`` (NO_MESH
    for None; with ``stages`` above 1 and no mesh, a pipeline of that
    many stages all run in this process), after checking that the port
    runs it (``mesh`` may be a DeviceMesh, a MeshSpec or a sizes mapping
    for the checks): a MoE ``cfg`` under
    ``stage`` and ``sequence`` both above 1 raises NotImplementedError
    naming its ROADMAP row; ``stage`` (or ``stages``) that does not
    divide the layers, heads or KV heads that ``tensor`` does not divide,
    ``stages`` beside a mesh and microbatches below 1 raise ValueError.
    ``num_microbatches`` is used only when there are stages (JAX ignores
    it otherwise). A mesh that passes must be a DeviceMesh."""
    if stages > 1 and mesh is not None:
        raise ValueError("stages runs every stage in this process: pass no mesh")
    if num_microbatches is not None and num_microbatches < 1:
        raise ValueError(f"num_microbatches {num_microbatches} < 1")
    n_stage = mesh_axis_size(mesh, "stage") if mesh is not None else stages
    if cfg is not None:
        if cfg.layers % n_stage:
            raise ValueError(f"stage={n_stage} must divide layers ({cfg.layers})")
        n_seq = mesh_axis_size(mesh, "sequence")
        if cfg.num_experts and n_stage > 1 and n_seq > 1:
            # JAX routes per sequence shard of a microbatch there, per the
            # whole batch under sequence alone: no one function to match
            raise NotImplementedError(
                f"a mixture-of-experts config under stage={n_stage} and sequence={n_seq} "
                f"is not ported (ROADMAP.md {_MOE_PP_SP})")
        n = mesh_axis_size(mesh, "tensor")
        if cfg.heads % n or cfg.kv_heads % n:
            # contiguous head cuts keep the GQA map (query head h reads KV
            # head h // (heads / kv_heads)) only if tensor divides both
            raise ValueError(f"tensor={n} must divide heads ({cfg.heads}) and "
                             f"kv_heads ({cfg.kv_heads})")
    if mesh is None:
        return dataclasses.replace(NO_MESH, n_stage=stages)
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh: a DeviceMesh from build_mesh, not {type(mesh).__name__}")
    return mesh_groups(mesh)


def microbatches(groups: MeshGroups, num_microbatches: Optional[int]) -> Optional[int]:
    """The number of microbatches the layer stack runs in: None without a
    pipeline, else ``num_microbatches`` or twice the stages (JAX's
    default)."""
    if groups.n_stage == 1:
        return None
    return num_microbatches or 2 * groups.n_stage


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


def param_axes(cfg: TransformerConfig) -> Params:
    """The params dict's structure with each leaf's logical axis names,
    one per dim, as the JAX package names them: parallel.sharding maps
    them onto a mesh (``spec_for``, ``shard_tree``)."""
    block_axes: Params = {
        "wq": ("layers", "embed", "heads", "head_dim"),
        "wk": ("layers", "embed", "kv_heads", "head_dim"),
        "wv": ("layers", "embed", "kv_heads", "head_dim"),
        "wo": ("layers", "heads", "head_dim", "embed"),
        "ln_attn": ("layers", "norm"),
        "ln_mlp": ("layers", "norm"),
    }
    if cfg.num_experts:
        block_axes.update({
            "router": ("layers", "embed", None),  # router stays replicated
            "wi_gate": ("layers", "expert", "embed", "mlp"),
            "wi_up": ("layers", "expert", "embed", "mlp"),
            "wo_mlp": ("layers", "expert", "mlp", "embed"),
        })
    else:
        block_axes.update({
            "wi_gate": ("layers", "embed", "mlp"),
            "wi_up": ("layers", "embed", "mlp"),
            "wo_mlp": ("layers", "mlp", "embed"),
        })
    axes: Params = {
        "embed": ("vocab", "embed"),
        "blocks": block_axes,
        "ln_f": ("norm",),
    }
    if not cfg.tie_embeddings:
        axes["unembed"] = ("embed", "vocab")
    if cfg.lora_rank:
        axes["lora"] = {
            "wq_a": ("layers", "embed", "lora_rank"), "wq_b": ("layers", "lora_rank", "heads"),
            "wv_a": ("layers", "embed", "lora_rank"), "wv_b": ("layers", "lora_rank", "kv_heads"),
            "wi_a": ("layers", "embed", "lora_rank"), "wi_b": ("layers", "lora_rank", "mlp"),
        }
    return axes


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


def _lora_delta(x, a, b, scale, tensor=None):
    """LoRA's ``x·A·B·scale``. Under tensor parallelism B is cut on its
    output dim: ``x·A`` (replicated) enters the cut product through
    ``sum_grads``, so every rank holds the whole grad of A and of x's
    share through it."""
    return sum_grads(torch.einsum("bsh,hr->bsr", x, a.to(x.dtype)), tensor) \
        @ b.to(x.dtype) * scale


def _qkv(cfg: TransformerConfig, y, p, lora, positions, groups: MeshGroups = NO_MESH):
    """Projections + LoRA + RoPE shared by _block and the cached block.
    Returns q [B,S,nh,hd], k/v [B,S,nkv,hd] (this rank's heads under
    tensor parallelism)."""
    b, s, _ = y.shape
    hd = cfg.hd
    yt = sum_grads(y, groups.tensor)
    q = torch.einsum("bsh,hnd->bsnd", yt, p["wq"].to(y.dtype))
    k = torch.einsum("bsh,hnd->bsnd", yt, p["wk"].to(y.dtype))
    v = torch.einsum("bsh,hnd->bsnd", yt, p["wv"].to(y.dtype))
    if lora is not None:
        scale = cfg.lora_alpha / cfg.lora_rank
        q = q + _lora_delta(y, lora["wq_a"], lora["wq_b"], scale,
                            groups.tensor).reshape(b, s, -1, hd)
        v = v + _lora_delta(y, lora["wv_a"], lora["wv_b"], scale,
                            groups.tensor).reshape(b, s, -1, hd)
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


def _moe_mlp(cfg: TransformerConfig, y, p, groups: MeshGroups = NO_MESH):
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
    an empty slot, an entry of another rank's expert) go to one spare
    last row, which is cut off.

    Under a mesh (``groups``), as the JAX package's sharded step computes
    it: the tokens of the sequence group (along S) and of the batch group
    (rows) are gathered, in the global batch's row-major order, so
    routing, the capacity C and the slot order come from the global
    batch (under a pipeline, the global microbatch: each stage's
    microbatch is each rank's share of it, ``shard_batch``); the rank's
    E/n local experts (``p``'s expert leaves are its shard, their ``mlp``
    dim cut over tensor) run on their slots; the expert outputs are
    summed over the expert and tensor groups (``groups.moe``); the rank
    keeps its own rows and sequence shard. The gathers' backward
    reduce-scatters the grads of the tokens, each rank's rows coming home
    summed."""
    b, s, h = y.shape
    k = cfg.experts_per_token
    ys = gather_dim(y, 1, groups.seq)  # [b, S, h]: the whole sequence
    s_all = ys.shape[1]
    x = gather_rows(ys.reshape(b * s_all, h), groups.batch)
    t = x.shape[0]
    e = p["wi_gate"].shape[0]  # local experts
    if e * groups.n_expert != cfg.num_experts:
        raise ValueError(f"{e} experts on each of {groups.n_expert} ranks: "
                         f"the config has {cfg.num_experts}")
    r = moe_routing(cfg, x, p["router"])
    cap = r.capacity
    # each entry's row in the [E*C] buffer of the local experts, or the
    # spare row if it was dropped or its expert is another rank's
    local = r.gate_idx.T.reshape(k * t) - groups.expert_rank * e
    mine = r.keep & (local >= 0) & (local < e)
    row = torch.where(mine, local * cap + r.slot, e * cap)
    xk = sum_grads(x, groups.moe).repeat(k, 1)
    xe = x.new_zeros(e * cap + 1, h).index_copy(0, row, xk)
    out_e = _expert_ffn(xe[:-1].view(e, cap, h), p).view(e * cap, h)
    # each buffer row's entry, or the spare entry if no entry landed there
    entry = torch.full((e * cap + 1,), k * t, dtype=torch.long, device=x.device)
    entry = entry.scatter(0, row, torch.arange(k * t, device=x.device))[:-1]
    yk = out_e.new_zeros(k * t + 1, h).index_copy(0, entry, out_e)[:-1]
    yk = sum_partials(yk, groups.moe)
    yk = yk * r.gate_vals.T.reshape(k * t).to(y.dtype)[:, None]
    out = yk.view(k, t, h).sum(0)
    first = groups.batch_rank * b * s_all
    out = out[first:first + b * s_all].view(b, s_all, h)
    return out[:, groups.seq_rank * s:(groups.seq_rank + 1) * s]


def _mlp(cfg: TransformerConfig, x, p, lora, groups: MeshGroups = NO_MESH):
    """Second half of a block: x + SwiGLU(RMSNorm(x)), or the mixture of
    experts for a MoE config (which, as in JAX, reads no LoRA adapter).
    Under tensor parallelism ``wi_*`` are cut on mlp (column-parallel)
    and ``wo_mlp`` on its input (row-parallel, outputs summed)."""
    y = _rms_norm(x, p["ln_mlp"], cfg.norm_eps)
    if cfg.num_experts:
        return x + _moe_mlp(cfg, y, p, groups)
    yt = sum_grads(y, groups.tensor)
    gate = torch.einsum("bsh,hm->bsm", yt, p["wi_gate"].to(y.dtype))
    up = torch.einsum("bsh,hm->bsm", yt, p["wi_up"].to(y.dtype))
    if lora is not None:
        gate = gate + _lora_delta(y, lora["wi_a"], lora["wi_b"],
                                  cfg.lora_alpha / cfg.lora_rank, groups.tensor)
    act = F.silu(gate) * up
    out = torch.einsum("bsm,mh->bsh", act, p["wo_mlp"].to(act.dtype))
    return x + sum_partials(out, groups.tensor)


def _attention(cfg: TransformerConfig, x, p, lora, positions, attn_fn,
               groups: MeshGroups = NO_MESH):
    """First half of a block: x + attention(RMSNorm(x)); under tensor
    parallelism on this rank's heads, ``wo``'s partial outputs summed."""
    y = _rms_norm(x, p["ln_attn"], cfg.norm_eps)
    q, k, v = _qkv(cfg, y, p, lora, positions, groups)
    attn = attn_fn(q, k, v)
    out = torch.einsum("bsnd,ndh->bsh", attn, p["wo"].to(attn.dtype))
    return x + sum_partials(out, groups.tensor)


def _gathered(tree, axes, group, skip=()):
    """One layer's leaves ``tree`` with each leaf the rules cut over fsdp
    gathered whole along that dim; ``axes`` are ``param_axes``' entries
    for the stacked leaves (their ``layers`` dim dropped here). A leaf
    the model does not know, or in ``skip``, is left as it is."""
    out = {}
    for k, t in tree.items():
        dim = None if k in skip else axis_dim(axes.get(k, ())[1:], "fsdp")
        out[k] = t if dim is None else gather_dim(t, dim, group)
    return out


def _block(cfg: TransformerConfig, x, layer_params, lora_params, positions,
           attn_fn, groups: MeshGroups = NO_MESH):
    """One decoder block. x [B,S,H_emb] in compute dtype. The block's
    leaves cut over fsdp are gathered first (again in the remat re-run,
    so no gathered leaf outlives the block)."""
    axes = param_axes(cfg)
    lp = _gathered(layer_params, axes["blocks"], groups.fsdp)
    lo = lora_params
    if lo is not None:  # under MoE wi_a/wi_b are never read, as in JAX
        lo = _gathered(lo, axes["lora"], groups.fsdp,
                       ("wi_a", "wi_b") if cfg.num_experts else ())
    x = _attention(cfg, x, lp, lo, positions, attn_fn, groups)
    return _mlp(cfg, x, lp, lo, groups)


def _default_attn(cfg: TransformerConfig, groups: MeshGroups = NO_MESH):
    # no gqa_expand: the flash kernel maps query head h to KV head
    # h // (heads / kv_heads) itself, which is the same function
    if groups.n_seq > 1:
        def ring(q, k, v):
            return ring_attention(q, k, v, groups.seq, causal=True)
        return ring

    def attn(q, k, v):
        return flash_attention(q, k, v, causal=True)
    return attn


def _embed(cfg: TransformerConfig, params: Params, tokens, groups: MeshGroups):
    """The embedding lookup, vocab-parallel under tensor parallelism: the
    rank's rows of the table (gathered over fsdp on embed) serve the
    tokens in its vocabulary range, the others read 0, and the rows are
    summed over the tensor group."""
    table = gather_dim(params["embed"], 1, groups.fsdp).to(cfg.dtype)
    rows = table.shape[0]
    local = tokens - groups.tensor_rank * rows
    mine = (local >= 0) & (local < rows)
    x = torch.where(mine[..., None], table[local.clamp(0, rows - 1)], 0.0)
    return sum_partials(x, groups.tensor)


def _logits(cfg: TransformerConfig, params: Params, x, groups: MeshGroups = NO_MESH):
    """Final norm + vocabulary projection: x [B,S,h] → logits [B,S,V]
    (this rank's vocabulary range under tensor parallelism)."""
    x = sum_grads(_rms_norm(x, params["ln_f"], cfg.norm_eps), groups.tensor)
    w = params.get("unembed")
    if w is None:
        w = gather_dim(params["embed"], 1, groups.fsdp).T
    else:
        w = gather_dim(w, 0, groups.fsdp)
    return torch.einsum("bsh,hv->bsv", x, w.to(x.dtype))


def forward(cfg: TransformerConfig, params: Params, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            attn_fn=None, mesh=None,
            num_microbatches: Optional[int] = None) -> torch.Tensor:
    """tokens [B,S] int → logits [B,S,V] (compute dtype).

    ``attn_fn(q,k,v)->o`` overrides attention. Under ``mesh`` (a
    DeviceMesh), ``tokens`` are this rank's part of the global batch
    (``parallel.shard_batch``: rows, and a contiguous sequence shard),
    ``params`` its shards, and the logits its rows, positions and, under
    tensor parallelism, vocabulary range; see ``check_mesh`` for the
    meshes the port takes. With ``stage`` above 1 the layer stack is a
    pipeline of ``num_microbatches`` (default twice the stages).
    ``positions`` default to the shard's global ones."""
    groups = check_mesh(mesh, num_microbatches, cfg)
    return _forward(cfg, params, tokens, positions, attn_fn, groups,
                    microbatches(groups, num_microbatches))


def _forward(cfg: TransformerConfig, params: Params, tokens, positions, attn_fn,
             groups: MeshGroups, num_microbatches: Optional[int] = None):
    s = tokens.shape[1]
    if positions is None:
        positions = torch.arange(s, device=tokens.device) + groups.seq_rank * s
    attn_fn = attn_fn or _default_attn(cfg, groups)

    def run_layers(layers, x, pos):
        # Full per-block remat, as the JAX package's jax.checkpoint: the
        # backward re-runs each block from its input. A selective policy
        # that kept the attention output would not help: the flash
        # backward needs the LSE, which only the re-run forward kernel
        # produces.
        remat = cfg.remat and torch.is_grad_enabled()
        for lp, lo in layers:
            if remat:
                x = checkpoint(_block, cfg, x, lp, lo, pos, attn_fn, groups,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = _block(cfg, x, lp, lo, pos, attn_fn, groups)
        return x

    x = _embed(cfg, params, tokens, groups)
    layers = [_layer(params, i) for i in range(len(params["blocks"]["wq"]))]
    if groups.n_stage > 1:
        x = pipelined_layers(run_layers, layers, x, positions, num_microbatches,
                             groups.n_stage, groups.stage)
    else:
        x = run_layers(layers, x, positions)
    return _logits(cfg, params, x, groups)


def _next_tokens(tokens, mask, groups: MeshGroups):
    """(targets, weight), both [B,S]: position p's target is token p+1 of
    the whole sequence, weighted by the loss_mask there (1 without one).
    A sequence shard's last target is the next shard's first token,
    fetched by an all-gather of every shard's first column; the last
    position of the whole sequence has no target (weight 0)."""
    b = tokens.shape[0]
    w = (torch.ones_like(tokens[:, 1:], dtype=torch.float32) if mask is None
         else mask[:, 1:].float())
    nxt_tok = torch.zeros_like(tokens[:, :1])
    nxt_w = torch.zeros_like(w[:, :1])
    if groups.seq is not None:
        # float64 holds both a token id and a mask weight exactly
        first = torch.stack([tokens[:, 0].double(),
                             torch.ones(b, dtype=torch.float64, device=tokens.device)
                             if mask is None else mask[:, 0].double()])
        heads = gather_rows(first[None], groups.seq)  # [n_seq, 2, B]
        if groups.seq_rank + 1 < groups.n_seq:
            nxt_tok = heads[groups.seq_rank + 1, 0, :, None].to(tokens.dtype)
            nxt_w = heads[groups.seq_rank + 1, 1, :, None].float()
    return (torch.cat([tokens[:, 1:], nxt_tok], 1).long(), torch.cat([w, nxt_w], 1))


def loss_fn(cfg: TransformerConfig, params: Params, batch, attn_fn=None,
            mesh=None, num_microbatches: Optional[int] = None, *, stages: int = 1):
    """Next-token cross-entropy. batch: tokens [B,S] int, optional
    loss_mask [B,S]. Returns (loss, {"loss", "accuracy", "tokens"}), all
    0-dim fp32 tensors on the tokens' device (no host sync).

    The loss is the sum of the nll over the kept targets divided by
    their count, ``tokens``. Under ``mesh`` ``batch`` holds this rank's
    part (as ``forward``'s tokens): the count is the global one (the mask
    summed over the ranks of other tokens, as JAX divides by the global
    mask sum), the metrics are the global values, the same on every rank,
    and ``loss`` is this rank's share of the global loss (the shares sum
    to it over those ranks), the value to differentiate. Under tensor
    parallelism the log-sum-exp, the target logit and the argmax (ties to
    the lowest index, as ``torch.argmax`` over the whole vocabulary) are
    reduced over the tensor group. Under a pipeline (``stage`` above 1,
    ``num_microbatches``: see ``forward``; or ``stages`` above 1 and no
    mesh, every stage run in this process on the whole ``params``) the
    loss is over the whole batch, not per microbatch; every stage
    computes it, and ``loss`` is 0 on every stage but the last, so that
    the grads of the leaves every stage holds (embed, unembed, ln_f) sum
    over the stages to the loss's."""
    groups = check_mesh(mesh, num_microbatches, cfg, stages)
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    # Forward over the whole shard (as the JAX package, whose sequence
    # shards must keep S divisible by the mesh axis); shift at the targets.
    logits = _forward(cfg, params, tokens, None, attn_fn, groups,
                      microbatches(groups, num_microbatches)).float()
    targets, weight = _next_tokens(tokens, mask, groups)
    vocab = logits.shape[-1]
    first = groups.tensor_rank * vocab
    with torch.no_grad():
        top = logits.amax(-1)
        m = max_over(top, groups.tensor)
        # the lowest index that holds the global max (vocab * n if none here)
        cand = torch.where(top == m, logits.argmax(-1) + first, vocab * groups.n_tensor)
        pred = min_over(cand, groups.tensor)
    local = targets - first
    mine = (local >= 0) & (local < vocab)
    tgt = torch.take_along_dim(logits, local.clamp(0, vocab - 1)[..., None], dim=-1)[..., 0]
    # (logits - m).exp_(): one [B,S,V] temporary, as torch.logsumexp makes
    parts = torch.stack([(logits - m[..., None]).exp_().sum(-1),
                         torch.where(mine, tgt, 0.0)])
    sumexp, tgt_logit = sum_partials(parts, groups.tensor).unbind(0)
    nll = (torch.log(sumexp) + m - tgt_logit) * weight
    acc = (pred == targets).float() * weight
    b, s = tokens.shape
    if mask is not None:
        denom = sum_partials(weight.sum(), groups.tokens).clamp_min(1.0)
    else:
        # a fill, not a host-to-device copy (which would sync the stream)
        denom = torch.full((), float(groups.n_batch * b * (groups.n_seq * s - 1)),
                           device=nll.device)
    nll_sum = nll.sum()
    sums = sum_partials(torch.stack([nll_sum.detach(), acc.sum()]), groups.tokens)
    share = nll_sum / denom
    if groups.stage is not None and groups.stage_rank + 1 < groups.n_stage:
        share = share * 0.0
    return share, {"loss": sums[0] / denom, "accuracy": sums[1] / denom, "tokens": denom}


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
