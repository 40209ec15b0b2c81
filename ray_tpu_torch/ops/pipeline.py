"""Pipeline parallelism: GPipe microbatching over the ``stage`` mesh axis
(PyTorch port of ray_tpu/ops/pipeline.py).

The layer-stacked params are cut on their leading ``layers`` dim over
``stage`` (ray_tpu_torch/parallel/sharding.py ``effective_rules``), so
stage s of n holds layers ``[s·L/n, (s+1)·L/n)``. The batch is cut into M
microbatches; stage s runs microbatch i − s at tick i, over M + n − 1
ticks (JAX's ``pipeline_spmd``). Activations cross every stage boundary
in fp32 and are cast to the compute dtype inside the stage, as JAX's
boundary does (exact for a bf16 activation); the last stage's outputs
are then made valid on every stage (``broadcast_last``: an fp32
all-reduce of the last stage's outputs and the others' zeros, JAX's
masked ``psum``).

JAX gets the reverse schedule from autodiff through ``scan`` +
``ppermute``. Autograd does not cross processes, so the port writes both
directions out as per-stage loops fed by a transport:

- ``pipeline_stage_fwd``: stage s's forward, microbatch by microbatch:
  its input (stage 0: its microbatch of the embedding; else received
  from stage s − 1) becomes a leaf, its layers run on it under autograd
  (with the model's per-block remat), the output goes to stage s + 1.
  The microbatches' graphs are kept.
- ``pipeline_stage_bwd``: in reverse microbatch order (JAX's reversed
  scan), the grad of each output (the last stage: from the loss; else
  received from stage s + 1) is backpropagated through the kept graph to
  the input, whose grad goes to stage s − 1, and to the stage's layer
  leaves, summed over the microbatches in the leaves' dtype (as JAX's
  scan transpose accumulates the grad of a closed-over param).

Bubble ticks (stage s before tick s and after tick M − 1 + s) launch
nothing: JAX runs the body there on clipped indices and drops the
result, the same answer. ``pipelined_layers`` wraps the loops in one
autograd function. Under a mesh (``group``, the stage group) each rank
runs its own stage's loops and the transport is ``StageLink``
(``isend``/``irecv`` on gloo or NCCL); without one, every stage's loops
run in this process, one stage after another, through ``LocalLink``
(a queue per pair of stages), as chip_smoke.py runs the pipeline on one
card.

The last stage's output grad is taken as it arrives there: the loss
(``loss_fn``) counts on the last stage only (its share is 0 on the
others), so no reduce over the stages is needed in the backward.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from ray_tpu_torch.parallel.collectives import LocalLink, StageLink, broadcast_last


def pipeline_stage_fwd(body: Callable, stage: int, n_stage: int, n_micro: int, link,
                       inputs: Optional[Sequence[torch.Tensor]], like: torch.Tensor,
                       grad: bool = True) -> list:
    """Stage ``stage`` of ``n_stage``'s forward over ``n_micro``
    microbatches: microbatch i at tick i + stage. ``body(h, i)`` runs the
    stage's layers on microbatch i's fp32 activation ``h``; stage 0 reads
    ``inputs[i]``, every other stage receives from ``stage - 1`` (buffers
    shaped as ``like``), and every stage but the last sends its output
    on. The next receive is posted before the current microbatch runs.
    Returns ``[(h, out)]`` by microbatch: with ``grad``, ``h`` is a leaf
    that requires grad and ``out`` carries the graph from it."""
    kept = []
    nxt = link.recv(like, stage - 1, stage) if stage else None
    for i in range(n_micro):
        if stage:
            h = nxt()
            if i + 1 < n_micro:
                nxt = link.recv(like, stage - 1, stage)
        else:
            h = inputs[i]
        h = h.detach().requires_grad_(grad)
        with torch.set_grad_enabled(grad):
            out = body(h, i)
        if stage + 1 < n_stage:
            link.send(out.detach(), stage, stage + 1)
        kept.append((h, out))
    link.finish()
    return kept


def pipeline_stage_bwd(kept: list, stage: int, n_stage: int, link,
                       leaves: List[torch.Tensor],
                       grads_out: Optional[Sequence[torch.Tensor]] = None):
    """Stage ``stage``'s backward over ``kept`` (its forward's ``(h,
    out)`` pairs, freed as they are used), microbatches in reverse order:
    the last stage takes ``grads_out[i]`` as microbatch i's output grad,
    every other stage receives it from ``stage + 1``; the grad of ``h``
    goes to ``stage - 1`` (stage 0 returns it). Returns (the input grads
    by microbatch on stage 0, else None; each of ``leaves``' grads summed
    over the microbatches, None for a leaf the stage does not read)."""
    n_micro = len(kept)
    acc: List[Optional[torch.Tensor]] = [None] * len(leaves)
    dxs = [None] * n_micro
    last = stage + 1 == n_stage
    nxt = None if last else link.recv(kept[-1][1], stage + 1, stage)
    for i in reversed(range(n_micro)):
        h, out = kept[i]
        kept[i] = None
        if last:
            g = grads_out[i]
        else:
            g = nxt()
            if i:
                nxt = link.recv(out, stage + 1, stage)
        grads = torch.autograd.grad(out, [h, *leaves], g, allow_unused=True)
        del h, out
        if stage:
            link.send(grads[0], stage, stage - 1)
        else:
            dxs[i] = grads[0]
        for j, gj in enumerate(grads[1:]):
            if gj is not None:
                acc[j] = gj.contiguous() if acc[j] is None else acc[j].add_(gj)
    link.finish()
    return (dxs if stage == 0 else None), acc


class _Schedule:
    """One pipelined run of the layer stack: the stages this process runs
    (its own under a mesh, all of them without), their kept graphs
    between the forward and the backward."""

    def __init__(self, apply_stage, spec, n_layers, pos_mb, n_stage, n_micro, group, dtype):
        self.apply_stage, self.spec, self.pos_mb = apply_stage, spec, pos_mb
        self.n_stage, self.n_micro, self.group, self.dtype = n_stage, n_micro, group, dtype
        self.stages = [dist.get_rank(group)] if group is not None else list(range(n_stage))
        self.per = n_layers // len(self.stages)  # layers a stage
        self.link = StageLink(group) if group is not None else LocalLink()

    def forward(self, x: torch.Tensor, leaves, grad: bool) -> torch.Tensor:
        """x: [B, S, H] fp32 → the last stage's outputs [B, S, H] fp32."""
        if grad:
            leaves = [t if t is None else t.detach().requires_grad_(t.requires_grad)
                      for t in leaves]
        self.leaves = leaves
        layers = tree_unflatten(leaves, self.spec)
        xs = x.chunk(self.n_micro)
        self.kept, out = {}, None
        for k, s in enumerate(self.stages):
            mine = layers[k * self.per:(k + 1) * self.per]

            def body(h, i, mine=mine):
                return self.apply_stage(mine, h.to(self.dtype), self.pos_mb(i)).float()

            kept = pipeline_stage_fwd(body, s, self.n_stage, self.n_micro, self.link,
                                      xs if s == 0 else None, xs[0], grad)
            if s == self.n_stage - 1:
                out = torch.cat([o.detach() for _, o in kept])
            self.kept[s] = kept if grad else None
        if self.group is not None:
            out = broadcast_last(x if out is None else out, self.group)
        return out

    def backward(self, g: torch.Tensor):
        """The grads of the input and of every leaf (None for one that
        does not require grad), from ``g`` [B, S, H] fp32, the output's
        grad (used on the last stage)."""
        grads = [None] * len(self.leaves)
        per_stage = len(self.leaves) // len(self.stages)
        dx = None
        for k, s in reversed(list(enumerate(self.stages))):
            idx = [j for j in range(k * per_stage, (k + 1) * per_stage)
                   if self.leaves[j] is not None and self.leaves[j].requires_grad]
            dxs, acc = pipeline_stage_bwd(self.kept.pop(s), s, self.n_stage, self.link,
                                          [self.leaves[j] for j in idx],
                                          g.chunk(self.n_micro))
            for j, a in zip(idx, acc):
                grads[j] = a
            if dxs is not None:
                dx = torch.cat(dxs)
        self.leaves = None
        # stages past the first do not read the input: its grad is 0 there
        return torch.zeros_like(g) if dx is None else dx, grads


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched, x, *leaves):
        ctx.sched = sched
        return sched.forward(x, leaves, grad=True)

    @staticmethod
    def backward(ctx, g):
        dx, grads = ctx.sched.backward(g.contiguous())
        ctx.sched = None
        return (None, dx, *grads)


def pipelined_layers(apply_stage: Callable, layers: list, x: torch.Tensor,
                     positions: torch.Tensor, num_microbatches: int, n_stage: int,
                     group=None) -> torch.Tensor:
    """Apply the layer stack under pipeline parallelism.

    ``apply_stage(stage_layers, h, pos) -> h`` runs a stage's layers (a
    list of per-layer param trees, each a dict or tuple of tensors) on
    ``h`` in the compute dtype at rope positions ``pos``. ``layers`` are
    the per-layer trees this process holds: under a mesh (``group``, the
    stage group of ``n_stage`` ranks) this rank's stage's L/n; without
    one, all L, run as ``n_stage`` stages here. ``x`` [B, S, H] (this
    rank's rows: under a mesh each microbatch's share, see
    ``shard_batch``); ``positions`` [S] (shared by every microbatch) or
    [B, S] (microbatched with the rows). Returns [B, S, H] in ``x``'s
    dtype, valid on every stage. Differentiable: the leaves of ``layers``
    and ``x`` get their grads through the per-stage backward loops.
    ValueError if ``num_microbatches`` does not divide B."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by microbatches {num_microbatches}")
    mb = b // num_microbatches
    if positions.dim() == 1:
        def pos_mb(i):
            return positions
    else:
        if positions.shape[0] != b:
            raise ValueError(f"positions batch dim {positions.shape[0]} != batch {b}")

        def pos_mb(i):
            return positions[i * mb:(i + 1) * mb]
    leaves, spec = tree_flatten(layers)
    sched = _Schedule(apply_stage, spec, len(layers), pos_mb, n_stage, num_microbatches,
                      group, x.dtype)
    h = x.float()
    if torch.is_grad_enabled() and (h.requires_grad or any(
            t is not None and t.requires_grad for t in leaves)):
        out = _Pipeline.apply(sched, h, *leaves)
    else:
        out = sched.forward(h, leaves, grad=False)
    return out.to(x.dtype)


__all__ = ["pipelined_layers", "pipeline_stage_fwd", "pipeline_stage_bwd"]
