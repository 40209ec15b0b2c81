"""Weights from the JAX package to the port.

``params_from_jax`` takes the JAX parameter pytree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's
params on ``device``. The port keeps the JAX layout, layer leaves stacked
on a leading ``layers`` dim, so every leaf maps one to one; only the
container and the array type change. This module never imports JAX.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch import default_device
from ray_tpu_torch.models.transformer import TransformerConfig, param_shapes

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
                    device=None, dtype: Optional[torch.dtype] = None):
    """JAX pytree of numpy arrays → the port's params dict. ``dtype``
    overrides every leaf's dtype (else each keeps its source dtype).
    Shapes are checked against the port's ``param_shapes``."""
    device = default_device(device)

    def convert(src, want, path):
        if isinstance(want, dict):
            if not isinstance(src, dict) or set(src) != set(want):
                raise ValueError(f"{path or 'params'}: expected keys {sorted(want)}")
            return {k: convert(src[k], want[k], f"{path}/{k}") for k in want}
        if tuple(np.shape(src)) != want[0]:
            raise ValueError(f"{path}: shape {np.shape(src)} != {want[0]}")
        return _leaf(src, device, dtype)

    return convert(np_params, param_shapes(cfg), "")
