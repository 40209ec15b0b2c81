"""Train step (PyTorch port of ray_tpu/train/step.py), on one device or
over a mesh.

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

Under a ``mesh`` (ray_tpu_torch.parallel.build_mesh; JAX's positional
order: ``init_state(cfg, opt, mesh)``, ``make_train_step(cfg, opt, mesh,
rules)``) each rank holds its shard of the state: expert leaves and their
moments cut over ``expert`` (``state_shardings``), every other leaf
whole. ``run`` takes the global batch, as JAX's does, and keeps this
rank's rows (``batch_sharding``). The grads are summed over the data
group, one in-place all-reduce a leaf; ``grad_norm`` and the clip's norm
are over the whole logical grads (the squares of expert shards summed
over the expert group); AdamW updates the local shards. The numbers are
those of the single-device step on the global batch. The mesh path runs
its collectives whatever the axes' sizes, so a mesh of one rank runs it
too. Axes the port does not take yet raise NotImplementedError naming
their ROADMAP item (ray_tpu_torch/models/transformer.py ``check_mesh``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import (
    Params, TransformerConfig, check_mesh, init_params, loss_fn, param_axes,
    param_shapes, trainable_leaves,
)
from ray_tpu_torch.parallel.collectives import all_reduce_, sum_partials
from ray_tpu_torch.parallel.mesh import mesh_device
from ray_tpu_torch.parallel.sharding import (
    Rules, is_sharded, shard_batch, shard_tree, spec_for,
)

TrainState = Dict[str, Any]

_STACKED = ("blocks", "lora")  # top-level keys whose leaves are [layers, ...]
# the JAX package's fixed AdamW and clip settings (ray_tpu/train/step.py:49-51)
B1, B2, EPS, MAX_NORM = 0.9, 0.95, 1e-8, 1.0


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


def _flat_grads(cfg: TransformerConfig, params: Params, batch, attn_fn=None,
                mesh=None):
    """(loss, metrics, tree, grads): ``tree`` is ``params`` with each
    leaf a detached leaf that requires grad (a stacked leaf as its
    per-layer leaves, sharing its storage); ``grads`` are their grads in
    ``_flatten(tree)`` order, the order of ``_units(params)``. Under
    ``mesh`` (``batch`` this rank's rows) the grads are summed over the
    data group in place: each rank holds the grads of the global loss,
    expert leaves' for its shard."""
    tree = _per_layer(params, torch.Tensor.detach)
    leaves = _flatten(tree)
    for t in leaves:
        t.requires_grad_()
    with torch.enable_grad():
        loss, metrics = loss_fn(cfg, tree, batch, attn_fn=attn_fn, mesh=mesh)
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
    grads = all_reduce_(grads, check_mesh(mesh).batch)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return metrics["loss"], metrics, tree, grads


def value_and_grad(cfg: TransformerConfig, params: Params, batch, attn_fn=None,
                   mesh=None, rules: Optional[Rules] = None
                   ) -> Tuple[Tuple[torch.Tensor, Dict], Params]:
    """``((loss, metrics), grads)`` with ``grads`` shaped like ``params``
    (stacked leaves stacked again), as ``jax.value_and_grad(loss_fn,
    has_aux=True)`` gives them. Under ``mesh``, ``batch`` is the global
    batch (as the step's) and ``params`` this rank's shards: the metrics
    and grads are the global loss's, an expert leaf's grad its shard. For
    tests and checks; the step itself keeps the per-layer grads."""
    loss, metrics, tree, grads = _flat_grads(
        cfg, params, shard_batch(mesh, batch, rules), attn_fn, mesh)
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


def state_shardings(cfg: TransformerConfig, optimizer: AdamW, mesh,
                    rules: Optional[Rules] = None) -> TrainState:
    """The train state's layout under ``mesh``, each leaf's ``spec_for``
    entries (as JAX's PartitionSpecs): the params' from ``param_axes``,
    Adam's moments as their params', () for the scalars. A leaf whose
    spec is not () holds this rank's shard."""
    check_mesh(mesh)
    specs = _map(param_axes(cfg), lambda axes: spec_for(axes, rules, mesh))
    train = trainable_leaves(cfg, specs)
    return {"params": specs, "opt_state": {"mu": train, "nu": train, "count": ()},
            "step": ()}


def batch_sharding(mesh, rules: Optional[Rules] = None) -> Tuple:
    """tokens [B, S] → the spec of (batch, seq): the batch cut over the
    data axes."""
    return spec_for(("batch", "seq"), rules, mesh)


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def init_state(cfg: TransformerConfig, optimizer: AdamW, mesh=None,
               rules: Optional[Rules] = None, seed: int = 0, *,
               device=None) -> TrainState:
    """Params from ``init_params`` with a generator seeded ``seed``, zero
    moments, step 0, on ``device`` (default: the mesh's device type, else
    the card). Under ``mesh`` each rank draws the whole init and keeps its
    shard (``state_shardings``), so the sharded state is the single-device
    one cut."""
    check_mesh(mesh)
    device = mesh_device(mesh, device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(seed),
                         device)
    if mesh is not None:  # clone a cut leaf: the whole one is freed
        params = shard_tree(mesh, params, param_axes(cfg), rules,
                            lambda t: t.clone() if t._base is not None else t)
    return {"params": params, "opt_state": optimizer.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    out = {k: torch.as_tensor(v).to(device) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


def _clone(tree):
    return ({k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.clone())


def make_train_step(cfg: TransformerConfig, optimizer: AdamW, mesh=None,
                    rules: Optional[Rules] = None, donate: bool = True,
                    num_microbatches: Optional[int] = None, *, device=None,
                    attn_fn=None) -> Callable[[TrainState, Dict], Tuple[TrainState, Dict]]:
    """(state, batch) → (state, metrics), on one device or over ``mesh``
    (``batch`` the global batch). The state is updated in place and
    returned; with ``donate=False`` a copy of it is, and the input stays
    as it was. ``attn_fn(q,k,v)`` overrides attention (default: the flash
    kernels)."""
    expert = check_mesh(mesh, num_microbatches).expert
    device = mesh_device(mesh, device)
    # per unit (the order of _flatten(tree)): whether it trains, and
    # whether it holds a shard cut over the mesh (an expert leaf), whose
    # squared norm is summed over the expert group
    meta = _map(param_shapes(cfg), lambda sf: torch.empty(sf[0], device="meta"))
    names = _paths(_per_layer(meta))
    trains = set(_paths(_per_layer(trainable_leaves(cfg, meta))))
    keep_idx = [i for i, n in enumerate(names) if n in trains]
    keep = torch.tensor(keep_idx, device=device)
    specs = _map(param_axes(cfg), lambda axes: spec_for(axes, rules, mesh))
    cut = torch.tensor([is_sharded(_leaf(specs, n)) for n in names], device=device)

    def run(state: TrainState, batch: Dict[str, Any]):
        if not donate:
            state = _clone(state)
        params = state["params"]
        _, metrics, tree, grads = _flat_grads(
            cfg, params, shard_batch(mesh, _batch_to(batch, device), rules), attn_fn, mesh)
        sq = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float32)).square()
        if expert is not None:
            sq = torch.where(cut, sum_partials(torch.where(cut, sq, 0.0), expert), sq)
        metrics["grad_norm"] = sq.sum().sqrt()
        optimizer.update_(_units(trainable_leaves(cfg, params)),
                          [grads[i] for i in keep_idx], state["opt_state"],
                          sq.index_select(0, keep).sum().sqrt())
        state["step"] += 1
        return state, metrics

    return run


def _leaf(tree, name: str):
    """The leaf of a params-shaped ``tree`` a unit name (``_paths``) is
    cut from: ``blocks/wq[3]`` → ``tree["blocks"]["wq"]``."""
    for key in name.split("[")[0].split("/"):
        tree = tree[key]
    return tree


def make_eval_step(cfg: TransformerConfig, mesh=None, rules: Optional[Rules] = None,
                   *, device=None) -> Callable:
    """(params, batch) → metrics, no grad; under ``mesh`` ``batch`` is the
    global batch and the metrics are global."""
    check_mesh(mesh)
    device = mesh_device(mesh, device)

    @torch.no_grad()
    def run(params: Params, batch: Dict[str, Any]):
        _, metrics = loss_fn(cfg, params, shard_batch(mesh, _batch_to(batch, device), rules),
                             mesh=mesh)
        return metrics

    return run
