"""The collectives of the sharded train step, as autograd functions, with
a count of calls by kind.

The JAX package's sharded step is one GSPMD program: XLA derives its
collectives from the shardings. The port writes them out, as Megatron
and ZeRO-3 do, with three autograd-aware primitives and a P2P ring:

- ``gather_rows`` / ``gather_dim``: all-gather; backward reduce-scatter.
  FSDP: a leaf cut over ``fsdp`` on its ``embed`` dim is gathered before
  the layer uses it, and its grad comes back summed over the fsdp group,
  each rank keeping its shard. MoE: a layer gathers its data group's
  tokens, so that routing, capacity and slot order run over the global
  batch.
- ``sum_partials``: all-reduce, identity backward. The partial products
  of a row-parallel projection (``wo``, ``wo_mlp`` cut on their input
  dim over ``tensor``), of a vocab-parallel embedding and of the expert
  group's outputs, summed into a value every member then holds whole.
- ``sum_grads``: identity, all-reduce backward. A value replicated over
  the group that enters a column-parallel product (``wq``/``wk``/``wv``/
  ``wi_*`` cut on their output dim, the unembedding cut over the
  vocabulary, the local experts): each member's share of its grad is
  summed, so every member holds the whole grad.
- ``exchange``: one step of a ring (``batch_isend_irecv``): send to the
  next rank of the group, receive from the previous (ring attention,
  ray_tpu_torch/ops/ring_attention.py).
- ``StageLink``: the pipeline's stage-to-stage transport (``isend`` /
  ``irecv`` to the next and previous stage of the stage group,
  ray_tpu_torch/ops/pipeline.py).

The ranks of a tensor or expert group compute the same values outside
the cut products. Counting that replicated work once is what
``sum_partials``'s identity backward and ``sum_grads``'s identity forward
do (an all-reduce whose backward all-reduces too would multiply the
grads by the group size). Parameter grads are then summed over the
ranks that hold other tokens (``all_reduce_``): over (replica, data,
sequence) for a leaf cut over fsdp, whose reduce-scatter already summed
the fsdp group, and over (replica, data, fsdp, sequence) for the rest.

A collective over a group of one rank still runs (a copy): the mesh
path issues the same calls whatever the sizes. ``group`` None means no
mesh, and every function here returns its input.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import weakref
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

# calls issued since the last reset_collectives(), by kind
_COUNTS: collections.Counter = collections.Counter()
KINDS = ("all_gather", "reduce_scatter", "all_reduce", "send")


def read_collectives() -> Dict[str, int]:
    """Collective calls issued since the last ``reset_collectives``, by
    kind (forward and backward alike); ``send`` counts the tensors sent
    point to point."""
    return {k: _COUNTS[k] for k in KINDS}


def reset_collectives() -> None:
    _COUNTS.clear()


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The process groups of a mesh the sharded step runs collectives on,
    with the sizes ``n_*`` and this rank's places ``*_rank`` the model
    reads. None (size 1, rank 0) means no mesh.

    - ``batch``: the axes the batch rows are cut on (replica, data, fsdp);
    - ``expert``, ``fsdp``, ``tensor``, ``seq``: one mesh axis each
      (``seq`` is the sequence axis);
    - ``stage``: the pipeline's stages, with ``n_stage`` and
      ``stage_rank``. ``n_stage`` above 1 with no ``stage`` group is a
      pipeline whose stages all run in this process (no mesh);
    - ``moe``: (expert, tensor), the ranks whose expert outputs a MoE
      layer sums (each holds its experts' cut of ``mlp``);
    - ``tokens``: every axis the tokens are cut on (replica, data, fsdp,
      sequence): the loss's sums, and the grads of leaves not cut over
      fsdp;
    - ``peers``: (replica, data, sequence), the ranks that hold the same
      fsdp shard of a leaf but other tokens: the grads of leaves cut over
      fsdp;
    - ``stage_tokens``, ``stage_peers``: ``tokens`` and ``peers`` with
      ``stage``: the grads of the leaves the pipeline leaves whole on
      every stage (embed, unembed, ln_f);
    - ``model``: the axes a leaf may be cut on (fsdp, stage, expert,
      tensor): the squared norms of the grad shards.
    """

    batch: Optional[dist.ProcessGroup] = None
    n_batch: int = 1
    batch_rank: int = 0
    expert: Optional[dist.ProcessGroup] = None
    n_expert: int = 1
    expert_rank: int = 0
    fsdp: Optional[dist.ProcessGroup] = None
    tensor: Optional[dist.ProcessGroup] = None
    n_tensor: int = 1
    tensor_rank: int = 0
    seq: Optional[dist.ProcessGroup] = None
    n_seq: int = 1
    seq_rank: int = 0
    stage: Optional[dist.ProcessGroup] = None
    n_stage: int = 1
    stage_rank: int = 0
    moe: Optional[dist.ProcessGroup] = None
    tokens: Optional[dist.ProcessGroup] = None
    peers: Optional[dist.ProcessGroup] = None
    stage_tokens: Optional[dist.ProcessGroup] = None
    stage_peers: Optional[dist.ProcessGroup] = None
    model: Optional[dist.ProcessGroup] = None
    n_model: int = 1


NO_MESH = MeshGroups()
_AXES = {"batch": ("replica", "data", "fsdp"), "expert": ("expert",), "fsdp": ("fsdp",),
         "tensor": ("tensor",), "seq": ("sequence",), "stage": ("stage",),
         "moe": ("expert", "tensor"),
         "tokens": ("replica", "data", "fsdp", "sequence"),
         "peers": ("replica", "data", "sequence"),
         "stage_tokens": ("replica", "data", "fsdp", "stage", "sequence"),
         "stage_peers": ("replica", "data", "stage", "sequence"),
         "model": ("fsdp", "stage", "expert", "tensor")}
_GROUPS: Dict[int, MeshGroups] = {}


def _group(mesh: DeviceMesh, axes, made: dict) -> dist.ProcessGroup:
    """The group of ranks that differ only along ``axes``. One axis: the
    mesh's own group for it. Several above 1: a new group for each
    combination of the other coordinates (every rank creates all of them,
    as ``new_group`` requires), this rank's returned; ``made`` keeps them
    by the axes above 1, so two names for the same ranks share one."""
    names = mesh.mesh_dim_names
    big = tuple(a for a in axes if mesh.size(names.index(a)) > 1)
    if len(big) <= 1:
        return mesh.get_group(big[0] if big else axes[-1])
    if big in made:
        return made[big]
    ranks = mesh.mesh
    dims = [names.index(a) for a in big]
    rest = [d for d in range(ranks.dim()) if d not in dims]
    size = math.prod(mesh.size(d) for d in dims)
    mine = None
    for row in ranks.permute(rest + dims).reshape(-1, size).tolist():
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    made[big] = mine
    return mine


def mesh_groups(mesh: Optional[DeviceMesh]) -> MeshGroups:
    """The ``MeshGroups`` of ``mesh`` (made once per mesh object);
    ``NO_MESH`` for None."""
    if mesh is None:
        return NO_MESH
    key = id(mesh)
    if key not in _GROUPS:
        kw, made = {}, {}
        for name, axes in _AXES.items():
            g = _group(mesh, axes, made)
            kw[name] = g
            if f"n_{name}" in MeshGroups.__dataclass_fields__:
                kw[f"n_{name}"] = dist.get_world_size(g)
            if f"{name}_rank" in MeshGroups.__dataclass_fields__:
                kw[f"{name}_rank"] = dist.get_rank(g)
        _GROUPS[key] = MeshGroups(**kw)
        weakref.finalize(mesh, _GROUPS.pop, key, None)
    return _GROUPS[key]


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    out = x.contiguous().clone()
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(out, op=op, group=group)
    return out


def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """[n * rows, ...]: the group's ``x`` along dim 0, in group-rank order."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0], *x.shape[1:]))
    _COUNTS["all_gather"] += 1
    dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _reduce_scatter(g: torch.Tensor, group) -> torch.Tensor:
    """The group's ``g`` [n * rows, ...] summed, this rank's rows kept."""
    out = g.new_empty((g.shape[0] // dist.get_world_size(group), *g.shape[1:]))
    _COUNTS["reduce_scatter"] += 1
    dist.reduce_scatter_tensor(out, g.contiguous(), group=group)
    return out


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        # the shards stacked on a new dim 0, then laid out along ``dim`` in
        # a contiguous tensor of the whole leaf's layout (a view for dim 0)
        n = dist.get_world_size(group)
        shape = list(x.shape)
        shape[dim] *= n
        return _all_gather(x, group).view(n, *x.shape).movedim(0, dim).reshape(shape)

    @staticmethod
    def backward(ctx, g):
        dim, n = ctx.dim, dist.get_world_size(ctx.group)
        shape = list(g.shape)
        shard = shape[:dim] + [shape[dim] // n] + shape[dim + 1:]
        shape[dim:dim + 1] = [n, shape[dim] // n]
        # each rank's part of the grad stacked on dim 0, as forward gathered it
        parts = g.reshape(shape).movedim(dim, 0).reshape(n * shard[0], *shard[1:])
        return _reduce_scatter(parts, ctx.group), None, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


def gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in group-rank order, a
    contiguous tensor. Backward: the grads summed over the group, each
    rank keeping its own part (reduce-scatter), the adjoint of the
    gather."""
    return x if group is None else _GatherDim.apply(x, dim, group)


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``gather_dim`` along dim 0."""
    return gather_dim(x, 0, group)


def max_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of the group's ``x`` (all-reduce), no grad."""
    return x if group is None else _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def min_over(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise min of the group's ``x`` (all-reduce), no grad."""
    return x if group is None else _all_reduce(x.detach(), group, dist.ReduceOp.MIN)


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's partial ``x``, a value every member then
    holds whole (all-reduce). Backward: identity, since each member's grad
    of that replicated value is already whole."""
    return x if group is None else _SumPartials.apply(x, group)


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over the group) used for a partial result.
    Backward: the members' grads summed (all-reduce), so each holds the
    whole grad of ``x``. Without a group, a view of ``x``: the graph then
    has the same shape as under a mesh, so grads that reach ``x`` by
    several paths are summed in the same order (bit for bit)."""
    return x.view_as(x) if group is None else _SumGrads.apply(x, group)


def all_reduce_(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The tensors summed over the group, each in place, one call a tensor
    (all issued, then waited on): no buffer beside the tensors
    themselves, but for a non-contiguous tensor (NCCL takes only
    contiguous ones), which is replaced by a contiguous copy."""
    if group is None:
        return tensors
    tensors = [t.contiguous() for t in tensors]
    works = []
    for t in tensors:
        _COUNTS["all_reduce"] += 1
        works.append(dist.all_reduce(t, group=group, async_op=True))
    for w in works:
        w.wait()
    return tensors


def exchange(send: List[torch.Tensor], recv: List[torch.Tensor], group) -> list:
    """One step of a ring over ``group``: each of ``send`` (contiguous) to
    the next rank of the group, each of ``recv`` filled from the previous
    one, all posted at once (``batch_isend_irecv``). Returns the requests
    to wait on."""
    n, me = dist.get_world_size(group), dist.get_rank(group)
    nxt = dist.get_global_rank(group, (me + 1) % n)
    prev = dist.get_global_rank(group, (me - 1) % n)
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in send]
    ops += [dist.P2POp(dist.irecv, t, prev, group) for t in recv]
    _COUNTS["send"] += len(send)
    return dist.batch_isend_irecv(ops)


class StageLink:
    """The pipeline's transport over the stage group (this rank is stage
    ``src`` of a send and ``dst`` of a receive): ``send`` posts an
    ``isend`` of a tensor to stage ``dst`` and returns at once (the tensor
    is kept until ``finish``); ``recv`` posts an ``irecv`` from stage
    ``src`` and returns a function that waits for it and gives the
    tensor. Between two stages tensors arrive in the order they were
    sent. Every send counts one ``send``."""

    def __init__(self, group):
        self.group, self.pending = group, []

    def send(self, x: torch.Tensor, src: int, dst: int) -> None:
        x = x.contiguous()
        _COUNTS["send"] += 1
        self.pending.append((x, dist.isend(x, dist.get_global_rank(self.group, dst),
                                           group=self.group)))

    def recv(self, like: torch.Tensor, src: int, dst: int):
        buf = torch.empty_like(like)
        work = dist.irecv(buf, dist.get_global_rank(self.group, src), group=self.group)

        def wait():
            work.wait()
            return buf
        return wait

    def finish(self) -> None:
        for _, work in self.pending:
            work.wait()
        self.pending = []


class LocalLink:
    """The pipeline's transport between stages that run in one process,
    one after another (each stage's loop runs whole before the next
    one's): a queue per pair of stages. Counts ``send`` as StageLink."""

    def __init__(self):
        self.queues = collections.defaultdict(collections.deque)

    def send(self, x: torch.Tensor, src: int, dst: int) -> None:
        _COUNTS["send"] += 1
        self.queues[src, dst].append(x)

    def recv(self, like: torch.Tensor, src: int, dst: int):
        return lambda: self.queues[src, dst].popleft()

    def finish(self) -> None:
        pass


def broadcast_last(x: torch.Tensor, group) -> torch.Tensor:
    """The last stage's ``x`` on every stage of ``group``: an all-reduce
    of ``x`` there and zeros elsewhere (no grad)."""
    last = dist.get_rank(group) == dist.get_world_size(group) - 1
    return _all_reduce(x if last else torch.zeros_like(x), group)
