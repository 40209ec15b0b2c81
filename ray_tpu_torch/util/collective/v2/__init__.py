"""Collective stack v2 — topology-aware hierarchical + quantized
collectives (copy of ray_tpu/util/collective/v2/__init__.py; EQuARX
arXiv 2506.17615, collectives-at-100k-GPUs arXiv 2510.20171).

Layers (each its own module, composed by the executor):

- :mod:`.topology` — where every rank lives (hosts, local groups,
  leaders, counterpart groups), built from one group-wide exchange.
- :mod:`.policy`   — group-agreed knobs + the (message size, world
  size, topology) -> algorithm/chunk selection table.
- :mod:`.quant`    — wire codecs: exact, and block-scaled int8 with
  dynamic per-block scaling and a documented, testable error bound.
- :mod:`.arena`    — ShmArena, the intra-host transport: one shm
  segment per host with per-rank input slots + a segment region and
  exactly three sync points per op.
- :mod:`.executor` — hierarchical reduce-scatter/allgather trees over
  (arena, object-path rendezvous).

Callers never import this package directly — `ObjStoreGroup` routes
`allreduce`/`allgather`/`reducescatter`/`broadcast` here per-op via the
group-agreed selection table.
"""

from ray_tpu_torch.util.collective.v2.arena import ShmArena
from ray_tpu_torch.util.collective.v2.executor import (
    HierarchicalExecutor,
    acc_dtype,
    seg_bounds,
    shard_bounds,
)
from ray_tpu_torch.util.collective.v2.policy import (
    GroupPolicy,
    chunk_bytes_for,
    local_knobs,
    merge_knobs,
    quant_codec_for,
    select_algorithm,
)
from ray_tpu_torch.util.collective.v2.quant import (
    QUANT_RTOL,
    ExactCodec,
    Int8BlockCodec,
    block_amax,
    sum_error_bound,
)
from ray_tpu_torch.util.collective.v2.topology import Topology, node_key

__all__ = [
    "ExactCodec",
    "GroupPolicy",
    "HierarchicalExecutor",
    "Int8BlockCodec",
    "QUANT_RTOL",
    "ShmArena",
    "Topology",
    "acc_dtype",
    "block_amax",
    "chunk_bytes_for",
    "local_knobs",
    "merge_knobs",
    "node_key",
    "quant_codec_for",
    "seg_bounds",
    "select_algorithm",
    "shard_bounds",
    "sum_error_bound",
]
