"""Collective communication (PyTorch port of ray_tpu.util.collective;
reference: python/ray/util/collective)."""

from ray_tpu_torch.util.collective.collective import (
    CollectiveHandle,
    allgather,
    allreduce,
    async_allreduce,
    barrier,
    broadcast,
    create_collective_group,
    destroy_collective_group,
    get_collective_group_size,
    get_rank,
    init_collective_group,
    is_group_initialized,
    recv,
    reducescatter,
    send,
)
from ray_tpu_torch.util.collective.types import (
    Backend,
    CollectiveError,
    CollectiveRankFailure,
    CollectiveTimeoutError,
    ReduceOp,
)

__all__ = [
    "Backend",
    "CollectiveError",
    "CollectiveHandle",
    "CollectiveRankFailure",
    "CollectiveTimeoutError",
    "ReduceOp",
    "allgather",
    "allreduce",
    "async_allreduce",
    "barrier",
    "broadcast",
    "create_collective_group",
    "destroy_collective_group",
    "get_collective_group_size",
    "get_rank",
    "init_collective_group",
    "is_group_initialized",
    "recv",
    "reducescatter",
    "send",
]
