"""NCCL collective group — eager collectives over a torch.distributed
group (PyTorch port of ray_tpu/util/collective/xla_group.py).

Each *process* is one group member, rank ``rank`` of ``world_size``; the
group runs over ranks ``[0, world_size)`` of the default process group
(``ray_tpu_torch.parallel.bootstrap.initialize_host`` brings that up
across processes). Tensors live on the current CUDA device under NCCL
and on the CPU under gloo; inputs may be numpy arrays or tensors.

A member may contribute a list of parts, one per local device, as an
XLAGroup member does. The ops then run over every part of every rank,
with part ``i`` of rank ``r`` the global part ``r * k + i`` (``k`` parts
a member, ``n = world_size * k`` in all), and return:

- ``allreduce``: the op over all n parts;
- ``allgather``: the stack of all n parts, ``[n, ...]``;
- ``reducescatter``: XLAGroup's global view of the op over all n parts
  is ``[n, chunk, ...]``, chunk ``j`` belonging to part ``j``; a member
  gets its own k rows of it, ``[k, chunk, ...]`` (at a world of one,
  the whole view).

A plain tensor is one part. Unlike XLAGroup, ``reducescatter`` reduces
MIN and PRODUCT as MIN and PRODUCT, and ``broadcast`` takes
``src_rank``'s tensor.
"""

from __future__ import annotations

import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch import default_device
from ray_tpu_torch.util.collective.types import Backend, CollectiveError, ReduceOp

_TORCH_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    ReduceOp.MAX: dist.ReduceOp.MAX,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MEAN: dist.ReduceOp.SUM,  # then divided by the part count
}
# the same ops over a member's own parts (dim 0), in the parts' dtype
_LOCAL_OPS = {
    ReduceOp.SUM: lambda x: x.sum(0, dtype=x.dtype),
    ReduceOp.PRODUCT: lambda x: x.prod(0, dtype=x.dtype),
    ReduceOp.MAX: lambda x: x.amax(0),
    ReduceOp.MIN: lambda x: x.amin(0),
    ReduceOp.MEAN: lambda x: x.sum(0, dtype=x.dtype),
}


def _reduce_parts(parts: torch.Tensor, op: ReduceOp) -> torch.Tensor:
    """A new tensor: ``op`` over a member's parts, ``[k, ...]`` → ``[...]``
    (one part is copied: the same values, at a copy's cost)."""
    return parts[0].clone() if parts.shape[0] == 1 else _LOCAL_OPS[op](parts)


# send/recv: a header of dtype code, number of dims and up to _MAX_DIMS sizes goes
# ahead of the payload, so the receiver needs to know nothing in advance
_WIRE_DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16,
                torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8,
                torch.bool)
_MAX_DIMS = 8
# torch renamed reduce_scatter_tensor to reduce_scatter_single (same call)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor

# The default process group this module brought up for a world of one,
# and how many groups stand on it; it is destroyed with the last of them.
_own_default_lock = threading.Lock()
_own_default = None
_own_default_users = 0


def _stand_on_default(world_size: int, backend: str, group_name: str) -> bool:
    """Make sure a default process group is up (bringing up a world of
    one when there is none and ``world_size`` is 1); True when it is the
    one this module brought up, which the caller then holds."""
    global _own_default, _own_default_users
    with _own_default_lock:
        if not dist.is_initialized():
            if world_size > 1:
                raise CollectiveError(
                    f"group '{group_name}' of {world_size} ranks needs the "
                    "default process group: call "
                    "ray_tpu_torch.parallel.bootstrap.initialize_host first")
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
            _own_default, _own_default_users = dist.group.WORLD, 0
        if _own_default is None or dist.group.WORLD is not _own_default:
            return False
        _own_default_users += 1
        return True


def _leave_own_default() -> None:
    global _own_default, _own_default_users
    with _own_default_lock:
        _own_default_users -= 1
        if _own_default_users == 0:
            if dist.is_initialized() and dist.group.WORLD is _own_default:
                dist.destroy_process_group()
            _own_default = None


class NCCLGroup:
    """Eager collective ops over one torch.distributed group.

    ``backend`` is ``Backend.NCCL`` (tensors on ``cuda:current``; raises
    without a card) or ``Backend.GLOO`` (the CPU). With ``world_size`` >
    1 the default process group must be up (``initialize_host``), hold
    at least ``world_size`` ranks, and give this process ``rank``; a
    world of one brings up its own when there is none."""

    def __init__(self, world_size: int, rank: int, group_name: str = "default",
                 backend: Backend = Backend.NCCL):
        backend = Backend.resolve(backend)
        self.world_size = world_size
        self.rank = rank
        self.group_name = group_name
        self.backend = backend
        if backend == Backend.NCCL:
            default_device(None)  # raises without a card
            self.device = torch.device("cuda", torch.cuda.current_device())
        else:
            self.device = torch.device("cpu")
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} is not in [0, {world_size})")
        self._owns_default = _stand_on_default(world_size, backend.value, group_name)
        if world_size > dist.get_world_size() or rank != dist.get_rank():
            if self._owns_default:
                _leave_own_default()
            raise CollectiveError(
                f"group '{group_name}': rank {rank} of {world_size} does not fit "
                f"the default process group (rank {dist.get_rank()} of "
                f"{dist.get_world_size()}); initialize_host sets that group up")
        try:
            self._pg = dist.new_group(
                list(range(world_size)), backend=backend.value,
                # a group smaller than the default one is made by its
                # members alone
                use_local_synchronization=world_size < dist.get_world_size(),
                group_desc=f"ray_tpu_torch.collective:{group_name}")
        except BaseException:
            if self._owns_default:
                _leave_own_default()
            raise

    # -- inputs --------------------------------------------------------
    def _tensor(self, x: Any) -> torch.Tensor:
        """``x`` as a tensor on the group's device (a copy only where it
        must move): the ops below write only into tensors they made."""
        if isinstance(x, torch.Tensor):
            return x.detach().to(self.device)
        return torch.as_tensor(np.asarray(x), device=self.device)

    def _parts(self, tensor: Any) -> torch.Tensor:
        """This member's parts stacked, ``[k, ...]``: a list holds one per
        local device, a plain tensor is one part."""
        if isinstance(tensor, (list, tuple)):
            return torch.stack([self._tensor(t) for t in tensor])
        return self._tensor(tensor)[None]

    # -- collectives ---------------------------------------------------
    def allreduce(self, tensor: Any, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        op = ReduceOp(op)
        parts = self._parts(tensor)
        if op == ReduceOp.MEAN and not parts.is_floating_point():
            parts = parts.float()
        out = _reduce_parts(parts, op)
        dist.all_reduce(out, op=_TORCH_OPS[op], group=self._pg)
        if op == ReduceOp.MEAN:
            out /= self.world_size * parts.shape[0]
        return out

    def allgather(self, tensor: Any) -> torch.Tensor:
        parts = self._parts(tensor)
        gathered = [torch.empty_like(parts) for _ in range(self.world_size)]
        dist.all_gather(gathered, parts, group=self._pg)
        return torch.cat(gathered)

    def reducescatter(self, tensor: Any, op: ReduceOp = ReduceOp.SUM) -> torch.Tensor:
        op = ReduceOp(op)
        parts = self._parts(tensor)
        if op == ReduceOp.MEAN and not parts.is_floating_point():
            parts = parts.float()
        k, m = parts.shape[0], parts.shape[1] if parts.dim() > 1 else 0
        n = self.world_size * k
        if parts.dim() < 2 or m % n:
            raise ValueError(f"reducescatter over {n} parts needs a leading dim "
                             f"divisible by {n}, not {tuple(parts.shape[1:])}")
        red = _reduce_parts(parts, op)  # [m, ...]: this member's parts reduced
        out = red.new_empty((m // self.world_size,) + red.shape[1:])
        _reduce_scatter(out, red, op=_TORCH_OPS[op], group=self._pg)
        if op == ReduceOp.MEAN:
            out /= n
        return out.reshape((k, m // n) + red.shape[1:])

    def broadcast(self, tensor: Any, src_rank: int = 0) -> torch.Tensor:
        if not 0 <= src_rank < self.world_size:
            raise ValueError(f"src_rank {src_rank} is not in [0, {self.world_size})")
        x = (torch.stack([self._tensor(t) for t in tensor])
             if isinstance(tensor, (list, tuple)) else self._tensor(tensor).clone())
        dist.broadcast(x, src=src_rank, group=self._pg)
        return x

    def barrier(self) -> None:
        # a one-element allreduce: NCCL's barrier wants device ids
        self.allreduce(torch.ones((), device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def send(self, tensor: Any, dst_rank: int) -> None:
        x = self._tensor(tensor).contiguous()
        if x.dtype not in _WIRE_DTYPES or x.dim() > _MAX_DIMS:
            raise TypeError(f"send takes up to {_MAX_DIMS} dims of {_WIRE_DTYPES}, "
                            f"not {x.dim()} of {x.dtype}")
        head = torch.zeros(2 + _MAX_DIMS, dtype=torch.int64)
        head[0], head[1] = _WIRE_DTYPES.index(x.dtype), x.dim()
        head[2:2 + x.dim()] = torch.tensor(x.shape, dtype=torch.int64)
        dist.send(head.to(self.device), dst=dst_rank, group=self._pg)
        dist.send(x, dst=dst_rank, group=self._pg)

    def recv(self, src_rank: int) -> torch.Tensor:
        head = torch.empty(2 + _MAX_DIMS, dtype=torch.int64, device=self.device)
        dist.recv(head, src=src_rank, group=self._pg)
        head = head.tolist()
        shape = head[2:2 + head[1]]
        x = torch.empty(shape, dtype=_WIRE_DTYPES[head[0]], device=self.device)
        dist.recv(x, src=src_rank, group=self._pg)
        return x

    def close(self) -> None:
        """Destroy the torch group (and the default group this group
        brought up for a world of one, once no group stands on it)."""
        pg, self._pg = self._pg, None
        if pg is not None:
            dist.destroy_process_group(pg)
            if self._owns_default:
                _leave_own_default()

