"""Single-device train step (PyTorch port of ray_tpu/train/step.py).

``make_train_step(cfg, optimizer)`` returns ``run(state, batch) ->
(state, metrics)``: the loss and the gradient of every leaf, a clip by
the global norm of the trainable grads (1.0), then AdamW (b1 0.9, b2
0.95, eps 1e-8, weight decay on every trainable leaf) — the update
``optax.chain(clip_by_global_norm(1.0), adamw(...))`` makes, wrapped for
LoRA in ``optax.multi_transform`` so that frozen leaves get no update.
The metrics (loss, accuracy, tokens, grad_norm) stay 0-dim tensors on
the device: nothing in the step waits for the card.

The train state is a dict: ``params`` (the model's params, stacked
layout), ``opt_state`` = ``{"mu", "nu", "count"}`` with mu and nu shaped
like the trainable leaves (``trainable_leaves``) in the params' dtype,
and ``step``. ``run`` updates the state in place and returns it: the
JAX step donates its input state, the port reuses its storage.

Every leaf takes a gradient, frozen base leaves included, as
``jax.value_and_grad`` computes them: ``grad_norm`` is the norm over all
grads (ray_tpu/train/step.py:194), the clip's norm over the trainable
ones only. Autograd through ``t[i]`` of a stacked leaf would build a
zero tensor the size of the whole stack for each layer's grad; the step
instead hands the forward, for each stacked leaf, a list of per-layer
leaves ``t.detach()[i].requires_grad_()`` that share the stack's
storage, each with its own grad, and the optimizer updates per-layer
views of the stack in place.

A ``mesh`` or ``num_microbatches`` (sharded and pipelined steps) is not
ported yet and raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ray_tpu_torch import default_device
from ray_tpu_torch.models.transformer import (
    Params, TransformerConfig, init_params, loss_fn, trainable_leaves,
)

TrainState = Dict[str, Any]

_STACKED = ("blocks", "lora")  # top-level keys whose leaves are [layers, ...]
# the JAX package's fixed AdamW and clip settings (ray_tpu/train/step.py:49-51)
B1, B2, EPS, MAX_NORM = 0.9, 0.95, 1e-8, 1.0
_MESH_TODO = ("sharded, pipelined and microbatched train steps are not "
              "ported yet (ROADMAP.md Queue A item 3: pipeline, ring "
              "attention, sharding and expert parallelism, the next slice)")


def _per_layer(tree: Params, leaf=None, stacked: bool = False) -> Params:
    """``tree`` with ``leaf`` applied to each tensor and each stacked leaf
    then replaced by the list of its per-layer views ``t[i]``. Keys come
    out sorted (as JAX orders a pytree), so trees built in another key
    order flatten alike."""
    out = {}
    for k, t in sorted(tree.items()):
        if isinstance(t, dict):
            out[k] = _per_layer(t, leaf, stacked or k in _STACKED)
            continue
        t = t if leaf is None else leaf(t)
        out[k] = [t[i] for i in range(t.shape[0])] if stacked else t
    return out


def _flatten(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, depth first, dict keys
    sorted."""
    if isinstance(tree, dict):
        return [t for _, v in sorted(tree.items()) for t in _flatten(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _flatten(v)]
    return [tree]


def _paths(tree, prefix: str = "") -> List[str]:
    """The names of ``_flatten(tree)``'s tensors, in its order, as
    ``key/key[layer]``."""
    if isinstance(tree, dict):
        return [n for k, v in sorted(tree.items())
                for n in _paths(v, f"{prefix}/{k}" if prefix else k)]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _paths(v, f"{prefix}[{i}]")]
    return [prefix]


def _units(tree: Params) -> List[torch.Tensor]:
    """The tensors the optimizer updates in place: each leaf, a stacked
    leaf as its per-layer views."""
    return _flatten(_per_layer(tree))


def _flat_grads(cfg: TransformerConfig, params: Params, batch, attn_fn=None):
    """(loss, metrics, tree, grads): ``tree`` is ``params`` with each
    leaf a detached leaf that requires grad (a stacked leaf as its
    per-layer leaves, sharing its storage); ``grads`` are their grads in
    ``_flatten(tree)`` order, the order of ``_units(params)``."""
    tree = _per_layer(params, torch.Tensor.detach)
    leaves = _flatten(tree)
    for t in leaves:
        t.requires_grad_()
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tree, batch, attn_fn=attn_fn)
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
    # LoRA's wi_a/wi_b are never read under MoE (as in JAX): they get the
    # zero grad jax.value_and_grad gives them. Any other unread leaf is a
    # fault (an adapter or weight that came unwired).
    unread = ("lora/wi_a[", "lora/wi_b[") if cfg.num_experts else ()
    for i, name in enumerate(_paths(tree)):
        if grads[i] is None:
            if not name.startswith(unread):
                raise ValueError(f"params leaf {name} is not read by the loss")
            grads[i] = torch.zeros_like(leaves[i])
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics["loss"], metrics, tree, grads


def value_and_grad(cfg: TransformerConfig, params: Params, batch,
                   attn_fn=None) -> Tuple[Tuple[torch.Tensor, Dict], Params]:
    """``((loss, metrics), grads)`` with ``grads`` shaped like ``params``
    (stacked leaves stacked again), as ``jax.value_and_grad(loss_fn,
    has_aux=True)`` gives them. For tests and checks; the step itself keeps
    the per-layer grads."""
    loss, metrics, tree, grads = _flat_grads(cfg, params, batch, attn_fn)
    it = iter(grads)  # grads come in _flatten(tree) order

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(v) for k, v in sorted(t.items())}
        return torch.stack([next(it) for _ in t]) if isinstance(t, list) else next(it)

    return (loss, metrics), fill(tree)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """clip_by_global_norm(MAX_NORM) then AdamW (B1, B2, EPS) over the
    leaves ``trainable_leaves(cfg, ·)`` selects; the others stay as they
    are."""

    cfg: TransformerConfig
    lr: float = 3e-4
    weight_decay: float = 0.1

    def init(self, params: Params) -> Dict[str, Any]:
        def zeros(tree):
            return {k: zeros(t) if isinstance(t, dict) else torch.zeros_like(t)
                    for k, t in tree.items()}
        train = trainable_leaves(self.cfg, params)
        device = _flatten(params)[0].device
        return {"mu": zeros(train), "nu": zeros(train),
                "count": torch.zeros((), dtype=torch.int32, device=device)}

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                opt_state: Dict[str, Any], grad_norm: torch.Tensor) -> None:
        """One step in place: ``params``, ``grads`` are the trainable leaves
        (``_units`` order, as are the moments); ``grad_norm`` is the global
        norm of ``grads``. No host sync: the clip selects on the device.
        The update runs over groups of at most ``_CHUNK`` elements, so its
        temporaries (three of a group's size) stay small beside the
        moments when every leaf trains."""
        mu, nu = _units(opt_state["mu"]), _units(opt_state["nu"])
        # optax: select(norm < max, g, g / norm * max)
        trigger = grad_norm < MAX_NORM
        clip = (torch.where(trigger, 1.0, grad_norm),
                torch.where(trigger, 1.0, MAX_NORM))
        count = opt_state["count"]
        count.add_(1)
        c = count.float()
        bc = (1 - B1 ** c, 1 - B2 ** c)
        for part in _groups(params, _CHUNK):
            self._update_group(params[part], grads[part], mu[part], nu[part], clip, bc)

    def _update_group(self, params, grads, mu, nu, clip, bc) -> None:
        g = torch._foreach_div(grads, clip[0])
        torch._foreach_mul_(g, clip[1])
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, g, alpha=1 - B1)
        torch._foreach_mul_(g, g)
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, g, alpha=1 - B2)
        den = torch._foreach_div(nu, bc[1])
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(mu, bc[0])
        torch._foreach_div_(upd, den)
        torch._foreach_add_(upd, params, alpha=self.weight_decay)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(params, upd)


_CHUNK = 1 << 28  # elements of one optimizer group (0.5 GB in bf16)


def _groups(tensors: List[torch.Tensor], limit: int) -> Iterator[slice]:
    """Slices of ``tensors`` in consecutive groups of at most ``limit``
    elements (a larger tensor makes a group of its own)."""
    start, size = 0, 0
    for i, t in enumerate(tensors):
        if i > start and size + t.numel() > limit:
            yield slice(start, i)
            start, size = i, 0
        size += t.numel()
    yield slice(start, len(tensors))


def default_optimizer(cfg: TransformerConfig, lr: float = 3e-4,
                      weight_decay: float = 0.1) -> AdamW:
    """AdamW + global-norm clip; LoRA configs train only the adapters."""
    return AdamW(cfg, lr=lr, weight_decay=weight_decay)


def init_state(cfg: TransformerConfig, optimizer: AdamW, seed: int = 0,
               device=None) -> TrainState:
    """Params from ``init_params`` with a generator seeded ``seed`` on
    ``device``, zero moments, step 0."""
    device = default_device(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def make_train_step(cfg: TransformerConfig, optimizer: AdamW, mesh=None,
                    device=None, num_microbatches: Optional[int] = None,
                    attn_fn=None) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """(state, batch) → (state, metrics) on one device. ``attn_fn(q,k,v)``
    overrides attention (default: the flash kernels)."""
    if mesh is not None or num_microbatches is not None:
        raise NotImplementedError(_MESH_TODO)
    device = default_device(device)

    def run(state: TrainState, batch: Dict[str, Any]):
        params = state["params"]
        _, metrics, tree, grads = _flat_grads(cfg, params,
                                              _batch_to(batch, device), attn_fn)
        pos = {id(t): i for i, t in enumerate(_flatten(tree))}
        keep = [pos[id(t)] for t in _flatten(trainable_leaves(cfg, tree))]
        norms = torch._foreach_norm(grads, 2, dtype=torch.float32)

        def global_norm(idx):
            return torch.stack([norms[i] for i in idx]).square().sum().sqrt()

        metrics["grad_norm"] = global_norm(range(len(grads)))
        optimizer.update_(_units(trainable_leaves(cfg, params)),
                          [grads[i] for i in keep], state["opt_state"],
                          global_norm(keep))
        state["step"] += 1
        return state, metrics

    return run


def make_eval_step(cfg: TransformerConfig, mesh=None,
                   device=None) -> Callable:
    """(params, batch) → metrics, no grad."""
    if mesh is not None:
        raise NotImplementedError(_MESH_TODO)
    device = default_device(device)

    @torch.no_grad()
    def run(params: Params, batch: Dict[str, Any]):
        _, metrics = loss_fn(cfg, params, _batch_to(batch, device))
        return metrics

    return run
