"""The plan executor of ray_tpu_torch.data (PyTorch port of
ray_tpu/data/_internal/executor.py).

Reference architecture: python/ray/data/_internal/execution/
streaming_executor.py:100 — operators pull upstream lazily, blocks flow
as ObjectRefs, bounded in-flight tasks give backpressure. Each logical
op maps block refs → block refs through remote tasks with a sliding
window (no materialize-the-world stages); in local mode (or with no
cluster) the calling process maps them itself. Functions travel by
value (``dumps_function``), so a worker needs no import of the module
that defined them.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.block import Block

# Max concurrently-running block tasks per op (backpressure window;
# reference: backpressure_policy/concurrency_cap_backpressure_policy.py).
DEFAULT_CONCURRENCY = 16


@ray_tpu_torch.remote
def _apply_block_fn(fn_bytes: bytes, *blocks: Block) -> Any:
    from ray_tpu_torch._private.serialization import loads_function

    fn = loads_function(fn_bytes)
    return fn(*blocks)


def _pack(fn: Callable) -> bytes:
    from ray_tpu_torch._private.serialization import dumps_function

    return dumps_function(fn)


@ray_tpu_torch.remote
def _partition_block_fn(fn_bytes: bytes, block: Block, k: int, idx: int) -> Any:
    """Map side of a distributed shuffle: fn(block, k, idx) -> k parts."""
    from ray_tpu_torch._private.serialization import loads_function

    parts = loads_function(fn_bytes)(block, k, idx)
    return parts if k > 1 else parts[0]


@ray_tpu_torch.remote
def _reduce_parts_fn(fn_bytes: bytes, *parts: Block) -> Any:
    """Reduce side: fn(list_of_parts) -> one output block."""
    from ray_tpu_torch._private.serialization import loads_function

    return loads_function(fn_bytes)(list(parts))


def _block(ref: Any) -> Block:
    return ray_tpu_torch.get(ref) if hasattr(ref, "id") else ref


class Executor:
    """Maps block refs through per-block remote tasks with a bounded
    in-flight window, yielding result refs in order as they finish."""

    def __init__(self, concurrency: int = DEFAULT_CONCURRENCY):
        self.concurrency = concurrency

    def map_refs(
        self,
        fn: Callable[[Block], Block],
        refs: Iterator[Any],
        local: bool = False,
    ) -> Iterator[Any]:
        """Lazily apply fn to each block ref. `local=True` short-circuits
        through the calling process (local mode, no cluster)."""
        if local:
            for r in refs:
                yield ray_tpu_torch.put(fn(_block(r)))
            return
        fn_b = _pack(fn)
        window: List[Any] = []
        for r in refs:
            window.append(_apply_block_fn.remote(fn_b, r))
            if len(window) >= self.concurrency:
                yield window.pop(0)
        while window:
            yield window.pop(0)

    def shuffle_refs(
        self,
        refs: List[Any],
        partition_fn: Callable[[Block, int, int], List[Block]],
        reduce_fn: Callable[[List[Block]], Block],
        num_outputs: Optional[int] = None,
        local: bool = False,
    ) -> Iterator[Any]:
        """Two-stage distributed shuffle (reference: map/reduce shuffle in
        _internal/planner/{sort,random_shuffle}.py): each input block is
        partitioned into k parts by a remote map task (which also receives
        its block index — per-block RNG seeds need it); reduce task j
        concatenates part j of every map output. Only REFS pass through
        the driver — blocks never materialize there."""
        refs = list(refs)
        if not refs:
            return
        k = num_outputs if num_outputs is not None else len(refs)
        k = max(1, k)
        if local:
            parts = [partition_fn(_block(r), k, i) for i, r in enumerate(refs)]
            for j in range(k):
                yield ray_tpu_torch.put(reduce_fn([p[j] for p in parts]))
            return
        pfn_b = _pack(partition_fn)
        rfn_b = _pack(reduce_fn)
        part_refs: List[List[Any]] = []
        for i, r in enumerate(refs):
            out = _partition_block_fn.options(num_returns=k).remote(pfn_b, r, k, i)
            part_refs.append(out if isinstance(out, list) else [out])
        for j in range(k):
            yield _reduce_parts_fn.remote(rfn_b, *[p[j] for p in part_refs])
