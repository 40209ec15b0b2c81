"""Blocks — the unit of data in ray_tpu_torch.data (copy of
ray_tpu/data/block.py).

Reference: python/ray/data/block.py + _internal/arrow_block.py. A block
is a batch of rows stored columnar; here the canonical in-memory format
is a dict of numpy arrays (``torch.from_numpy`` shares their memory on
the way to the card). Pyarrow tables / pandas frames convert on the
edges, and those packages are imported only there.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional

import numpy as np

Block = Dict[str, np.ndarray]


def block_from_rows(rows: List[Any]) -> Block:
    """List of rows (dicts or scalars) → columnar block."""
    if not rows:
        return {}
    first = rows[0]
    if isinstance(first, dict):
        keys = list(first.keys())
        return {k: np.asarray([r[k] for r in rows]) for k in keys}
    return {"item": np.asarray(rows)}


def block_to_rows(block: Block) -> List[Any]:
    if not block:
        return []
    keys = list(block.keys())
    n = block_num_rows(block)
    if keys == ["item"]:
        return [block["item"][i] for i in range(n)]
    return [{k: block[k][i] for k in keys} for i in range(n)]


def block_num_rows(block: Block) -> int:
    if not block:
        return 0
    return len(next(iter(block.values())))


def block_size_bytes(block: Block) -> int:
    return sum(v.nbytes if hasattr(v, "nbytes") else 0 for v in block.values())


def block_slice(block: Block, start: int, end: int) -> Block:
    return {k: v[start:end] for k, v in block.items()}


def block_concat(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if block_num_rows(b)]
    if not blocks:
        return {}
    keys = blocks[0].keys()
    return {k: np.concatenate([b[k] for b in blocks]) for k in keys}


def block_take(block: Block, indices: np.ndarray) -> Block:
    return {k: v[indices] for k, v in block.items()}


def block_select(block: Block, cols: List[str]) -> Block:
    return {k: block[k] for k in cols}


def normalize_batch(batch: Any) -> Block:
    """User map_batches output → block (accept dict / numpy / pandas / arrow)."""
    if batch is None:
        return {}
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    if isinstance(batch, np.ndarray):
        return {"item": batch}
    # pandas
    if hasattr(batch, "to_dict") and hasattr(batch, "columns"):
        return {c: np.asarray(batch[c]) for c in batch.columns}
    # pyarrow table
    if hasattr(batch, "column_names") and hasattr(batch, "to_pydict"):
        return {c: np.asarray(v) for c, v in batch.to_pydict().items()}
    if isinstance(batch, (list, tuple)):
        return block_from_rows(list(batch))
    raise TypeError(f"Unsupported batch type: {type(batch)}")


def to_batch_format(block: Block, batch_format: Optional[str]):
    """Block → user-facing batch ("numpy" dict, "pandas", "pyarrow")."""
    if batch_format in (None, "numpy", "default"):
        return dict(block)
    if batch_format == "pandas":
        import pandas as pd

        return pd.DataFrame({k: list(v) if v.ndim > 1 else v for k, v in block.items()})
    if batch_format == "pyarrow":
        import pyarrow as pa

        return pa.table({k: list(v) for k, v in block.items()})
    raise ValueError(f"Unknown batch_format: {batch_format}")
