"""Weights from the JAX package to the port.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's
params on ``device``. The port keeps the JAX layout, layer leaves stacked
on a leading ``layers`` dim, so every leaf maps one to one; only the
container and the array type change. ``state_from_jax`` does the same for
a whole train state, so a run trained in JAX continues in the port. This
module never imports JAX (nor optax: the caller pulls mu, nu and count
out of the optax state).

Under a ``mesh`` (ray_tpu_torch.parallel) both return this rank's shard:
each leaf, and its Adam moments, cut over fsdp, tensor, expert and (the
layer-stacked leaves' ``layers`` dim) stage as
``param_axes`` and the rules place them, so JAX's weights carry across
into a sharded state.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.models.transformer import (
    TransformerConfig, check_mesh, param_axes, param_shapes, trainable_leaves,
)
from ray_tpu_torch.parallel.mesh import mesh_device
from ray_tpu_torch.parallel.sharding import Rules, check_rules, local_shard

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def _leaf(a, device, dtype):
    a = np.asarray(a)
    src = _DTYPES.get(a.dtype.name)
    if src is None:
        raise TypeError(f"no torch dtype for {a.dtype}")
    # torch.from_numpy does not take ml_dtypes.bfloat16: go through fp32
    t = torch.from_numpy(a.astype(np.float32))
    return t.to(device=device, dtype=dtype or src)


def params_from_jax(np_params: Dict[str, Any], cfg: TransformerConfig,
                    device=None, dtype: Optional[torch.dtype] = None, mesh=None,
                    rules: Optional[Rules] = None):
    """JAX pytree of numpy arrays → the port's params dict. ``dtype``
    overrides every leaf's dtype (else each keeps its source dtype).
    Shapes are checked against the port's ``param_shapes``; under
    ``mesh`` each leaf is then cut to this rank's shard."""
    check_mesh(mesh, cfg=cfg)
    check_rules(rules)
    return _convert(np_params, param_shapes(cfg), param_axes(cfg),
                    mesh_device(mesh, device), dtype, "", mesh, rules)


def _convert(src, want, axes, device, dtype, path, mesh, rules):
    if isinstance(want, dict):
        if not isinstance(src, dict) or set(src) != set(want):
            raise ValueError(f"{path or 'params'}: expected keys {sorted(want)}")
        return {k: _convert(src[k], want[k], axes[k], device, dtype, f"{path}/{k}",
                            mesh, rules) for k in want}
    if tuple(np.shape(src)) != want[0]:
        raise ValueError(f"{path}: shape {np.shape(src)} != {want[0]}")
    return _leaf(local_shard(mesh, np.asarray(src), axes, rules), device, dtype)


def state_from_jax(np_state: Dict[str, Any], cfg: TransformerConfig,
                   device=None, mesh=None, rules: Optional[Rules] = None):
    """A JAX train state as numpy arrays → the port's train state
    (ray_tpu_torch/train/step.py). ``np_state`` holds ``params`` (the
    params pytree), ``mu`` and ``nu`` (Adam's moments of the trainable
    leaves only: the whole tree for dense, ``{"lora": ...}`` for LoRA),
    ``count`` (Adam's step count) and ``step``. Every leaf keeps its
    source dtype; shapes are checked; under ``mesh`` the params and
    moments are this rank's shards."""
    check_mesh(mesh, cfg=cfg)
    device = mesh_device(mesh, device)
    want = trainable_leaves(cfg, param_shapes(cfg))
    axes = trainable_leaves(cfg, param_axes(cfg))

    def scalar(name):
        return torch.full((), int(np.asarray(np_state[name])), dtype=torch.int32,
                          device=device)

    def moments(name):
        return _convert(np_state[name], want, axes, device, None, f"/{name}", mesh, rules)

    return {
        "params": params_from_jax(np_state["params"], cfg, device, mesh=mesh, rules=rules),
        "opt_state": {"mu": moments("mu"), "nu": moments("nu"), "count": scalar("count")},
        "step": scalar("step"),
    }
