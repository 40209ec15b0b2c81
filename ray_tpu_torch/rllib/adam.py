"""Adam over a tree of tensors, in place: the optimizer the JAX learners
get from ``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, no eps_root).

It follows optax's arithmetic: the moments as ``(1 - b) * g + b * m``,
an int32 step count, and the bias corrections ``1 - b ** count`` in
fp32, so a port learner and a JAX learner started from the same state
stay within fp32 rounding of each other. The transformer's
``train/step.py::AdamW`` clips by the global norm and decays weights for
a ``TransformerConfig``; this one does neither.

A tree is a dict of tensors or of such dicts (``{"pi": {...}, "vf":
{...}}``, SAC's 0-d ``log_alpha``). ``tree_map`` and ``tree_leaves``
walk it in the first tree's key order.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def tree_map(fn: Callable, tree, *others):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``others`` (trees of the same keys)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(o[k] for o in others)) for k, v in tree.items()}
    return fn(tree, *others)


def clone(tree):
    """A copy of a tree that no gradient reaches (a target network)."""
    return tree_map(lambda t: t.detach().clone(), tree)


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


class Adam:
    """``optax.adam(lr)`` over a tree of fp32 tensors. ``init`` gives the
    state ``{"count": int32 0-d, "mu": tree, "nu": tree}``; ``update_``
    takes a step in place, on the params' device, with no host sync."""

    def __init__(self, lr: float, b1: float = B1, b2: float = B2, eps: float = EPS):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps

    def init(self, params) -> Dict[str, Any]:
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def update_(self, params, grads: List[torch.Tensor], state: Dict[str, Any]) -> None:
        """One step: ``grads`` are the gradients of ``tree_leaves(params)``,
        in that order."""
        p, mu, nu = tree_leaves(params), tree_leaves(state["mu"]), tree_leaves(state["nu"])
        b1, b2 = self.b1, self.b2
        # mu = (1 - b1) * g + b1 * mu; nu = (1 - b2) * g**2 + b2 * nu
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        sq = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, sq)
        count = state["count"]
        count.add_(1)
        c = count.float()
        mu_hat = torch._foreach_div(mu, 1 - b1 ** c)
        den = torch._foreach_div(nu, 1 - b2 ** c)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(mu_hat, den)
        torch._foreach_mul_(mu_hat, -self.lr)
        torch._foreach_add_(p, mu_hat)
