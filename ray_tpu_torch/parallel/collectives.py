"""The collectives of the sharded train step, as autograd functions, with
a count of calls by kind.

The JAX package's sharded step is one GSPMD program: XLA derives its
collectives from the shardings. The port writes them out. At
``MeshSpec(data=d, expert=e)`` the batch is cut over the data group and
replicated over the expert group, and the experts are cut over the
expert group (ray_tpu/parallel/sharding.py:27), so a MoE layer

- gathers its data group's tokens (``gather_rows``), so that routing,
  capacity and slot order run over the global batch;
- runs its E/e local experts on their slots, the input entering through
  ``sum_grads`` (the local experts' share of its grad is summed over the
  expert group in the backward);
- sums the expert outputs over the expert group (``sum_partials``) and
  keeps its own rows.

Every rank then holds the whole grad of each replicated value, and each
rank of an expert group the same one: the ranks of an expert group
compute the same tokens after the combine, and counting that replicated
work once is what ``sum_partials``'s identity backward and
``sum_grads``'s identity forward do (an all-reduce whose backward is an
all-reduce too would multiply the grads by e). Parameter grads are then
summed over the data group (``all_reduce_``).

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
KINDS = ("all_gather", "reduce_scatter", "all_reduce")


def read_collectives() -> Dict[str, int]:
    """Collective calls issued since the last ``reset_collectives``, by
    kind (forward and backward alike)."""
    return {k: _COUNTS[k] for k in KINDS}


def reset_collectives() -> None:
    _COUNTS.clear()


@dataclasses.dataclass(frozen=True)
class MeshGroups:
    """The process groups of a mesh the sharded step runs collectives on,
    with this rank's place in each: ``batch`` over the axes the batch is
    cut on (replica, data, fsdp), ``expert`` over the expert axis. None
    (with size 1, rank 0) means no mesh."""

    batch: Optional[dist.ProcessGroup] = None
    n_batch: int = 1
    batch_rank: int = 0
    expert: Optional[dist.ProcessGroup] = None
    n_expert: int = 1
    expert_rank: int = 0


NO_MESH = MeshGroups()
_BATCH_AXES = ("replica", "data", "fsdp")
_GROUPS: Dict[int, MeshGroups] = {}


def _group(mesh: DeviceMesh, axes) -> dist.ProcessGroup:
    """The group of ranks that differ only along ``axes``. One axis: the
    mesh's own group for it. Several above 1: a new group for each
    combination of the other coordinates (every rank creates all of them,
    as ``new_group`` requires), this rank's returned."""
    names = mesh.mesh_dim_names
    big = [a for a in axes if mesh.size(names.index(a)) > 1]
    if len(big) <= 1:
        return mesh.get_group(big[0] if big else axes[-1])
    ranks = mesh.mesh
    dims = [names.index(a) for a in big]
    rest = [d for d in range(ranks.dim()) if d not in dims]
    size = math.prod(mesh.size(d) for d in dims)
    mine = None
    for row in ranks.permute(rest + dims).reshape(-1, size).tolist():
        g = dist.new_group(row)
        if dist.get_rank() in row:
            mine = g
    return mine


def mesh_groups(mesh: Optional[DeviceMesh]) -> MeshGroups:
    """The ``MeshGroups`` of ``mesh`` (made once per mesh object);
    ``NO_MESH`` for None."""
    if mesh is None:
        return NO_MESH
    key = id(mesh)
    if key not in _GROUPS:
        batch, expert = _group(mesh, _BATCH_AXES), _group(mesh, ("expert",))
        _GROUPS[key] = MeshGroups(batch, dist.get_world_size(batch), dist.get_rank(batch),
                                  expert, dist.get_world_size(expert), dist.get_rank(expert))
        weakref.finalize(mesh, _GROUPS.pop, key, None)
    return _GROUPS[key]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    _COUNTS["all_reduce"] += 1
    dist.all_reduce(out, group=group)
    return out


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = x.new_empty((n * x.shape[0], *x.shape[1:]))
        _COUNTS["all_gather"] += 1
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n, *g.shape[1:]))
        _COUNTS["reduce_scatter"] += 1
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


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


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """The group's ``x`` concatenated along dim 0 in group-rank order.
    Backward: the grads summed over the group, each rank keeping its own
    rows (reduce-scatter), the adjoint of the gather."""
    return x if group is None else _GatherRows.apply(x, group)


def sum_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the group's partial ``x``, a value every member then
    holds whole (all-reduce). Backward: identity, since each member's grad
    of that replicated value is already whole."""
    return x if group is None else _SumPartials.apply(x, group)


def sum_grads(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (replicated over the group) used for a partial result.
    Backward: the members' grads summed (all-reduce), so each holds the
    whole grad of ``x``."""
    return x if group is None else _SumGrads.apply(x, group)


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
