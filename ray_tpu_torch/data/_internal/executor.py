"""The plan executor of ray_tpu_torch.data (PyTorch port of
ray_tpu/data/_internal/executor.py).

Reference architecture: python/ray/data/_internal/execution/
streaming_executor.py:100. The JAX package maps block refs through
remote tasks with a sliding window, or, in local mode, through the
calling process. The port maps blocks in the calling process in either
mode (under a cluster too; the remote-task executor is ROADMAP.md Queue
A item 11), and functions pass by reference (nothing is pickled).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional

import ray_tpu_torch
from ray_tpu_torch.data.block import Block


def _block(ref: Any) -> Block:
    return ray_tpu_torch.get(ref) if hasattr(ref, "id") else ref


class Executor:
    """Maps block refs through a function in the calling process,
    yielding result refs in order."""

    def map_refs(
        self,
        fn: Callable[[Block], Block],
        refs: Iterator[Any],
    ) -> Iterator[Any]:
        """Lazily apply fn to each block ref."""
        for r in refs:
            yield ray_tpu_torch.put(fn(_block(r)))

    def shuffle_refs(
        self,
        refs: List[Any],
        partition_fn: Callable[[Block, int, int], List[Block]],
        reduce_fn: Callable[[List[Block]], Block],
        num_outputs: Optional[int] = None,
    ) -> Iterator[Any]:
        """Two-stage shuffle (reference: map/reduce shuffle in
        _internal/planner/{sort,random_shuffle}.py): each input block is
        partitioned into k parts (with its block index — per-block RNG
        seeds need it); output j concatenates part j of every block."""
        refs = list(refs)
        if not refs:
            return
        k = num_outputs if num_outputs is not None else len(refs)
        k = max(1, k)
        parts = [partition_fn(_block(r), k, i) for i, r in enumerate(refs)]
        for j in range(k):
            yield ray_tpu_torch.put(reduce_fn([p[j] for p in parts]))
