"""ray_tpu_torch.data — data loading and processing (PyTorch port of
ray_tpu.data; reference: ray.data).

Lazy block-based datasets over the object store; per-block ops fuse into
one task a block; under a cluster the plan runs in worker processes on
the streaming executor, in local mode in the calling process;
`iter_torch_batches` is the ingest path to the card.
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
