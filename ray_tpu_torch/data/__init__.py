"""ray_tpu_torch.data — data loading and processing (PyTorch port of
ray_tpu.data; reference: ray.data).

Lazy block-based datasets over the object store; per-block ops fuse into
one function a block; the plan runs in the calling process, in local mode
and under a cluster alike; `iter_torch_batches` is the ingest path to
the card. Execution over remote tasks is ROADMAP.md Queue A item 11.
"""

from ray_tpu_torch.data.block import Block
from ray_tpu_torch.data.dataset import Dataset, GroupedData
from ray_tpu_torch.data.read_api import (
    from_arrow,
    from_blocks,
    from_items,
    from_numpy,
    from_pandas,
    range,
    range_tensor,
    read_csv,
    read_json,
    read_numpy,
    read_parquet,
    read_text,
)

__all__ = [
    "Block",
    "Dataset",
    "GroupedData",
    "from_arrow",
    "from_blocks",
    "from_items",
    "from_numpy",
    "from_pandas",
    "range",
    "range_tensor",
    "read_csv",
    "read_json",
    "read_numpy",
    "read_parquet",
    "read_text",
]
