"""A JAX learner's state in the port: parameters and Adam state.

``params_from_jax`` takes a learner's parameter tree as numpy (what
``get_weights_np()`` returns, or ``Anakin.params``: any array that
``np.asarray`` reads) and returns the port's fp32 tensors on ``device``,
each requiring grad. ``adam_state_from_jax`` takes the state of
``optax.adam`` (the ``(ScaleByAdamState, EmptyState)`` tuple, or the
``ScaleByAdamState`` alone) and returns the port's ``Adam`` state:
count, mu and nu. A learner takes both through ``set_weights``, so a run
trained in JAX continues in the port. This module never imports JAX or
optax: it reads the state's ``count``, ``mu`` and ``nu`` fields.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch import default_device
from ray_tpu_torch.rllib.adam import tree_map


def _tensor(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)


def params_from_jax(np_params: Dict[str, Any], device=None) -> Dict[str, Any]:
    device = default_device(device)
    return tree_map(lambda a: _tensor(a, device).requires_grad_(), dict(np_params))


def adam_state_from_jax(opt_state: Any, device=None) -> Dict[str, Any]:
    device = default_device(device)
    state = next((s for s in (opt_state, *(opt_state if isinstance(opt_state, tuple) else ()))
                  if hasattr(s, "mu") and hasattr(s, "nu")), None)
    if state is None:
        raise TypeError(f"not an optax.adam state (no count, mu, nu): {type(opt_state)}")
    return {"count": torch.tensor(int(np.asarray(state.count)), dtype=torch.int32, device=device),
            "mu": tree_map(lambda a: _tensor(a, device), dict(state.mu)),
            "nu": tree_map(lambda a: _tensor(a, device), dict(state.nu))}


def to_numpy(tree) -> Dict[str, Any]:
    """A tree of tensors as numpy copies (the JAX learners' get_weights_np)."""
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)
