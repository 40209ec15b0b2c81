"""ray_tpu_torch.experimental — channels (mutable shared-memory objects)
and other pre-stable APIs (copy of ray_tpu/experimental/__init__.py;
reference: python/ray/experimental/). CUDA tensors cross processes
through ``experimental.rdt``."""

from ray_tpu_torch.experimental.channel import (
    Channel,
    ChannelReader,
    ChannelTimeoutError,
    ChunkPipe,
    ChunkPipeReader,
    TensorChannel,
    TensorChannelReader,
)

__all__ = [
    "Channel",
    "ChannelReader",
    "ChannelTimeoutError",
    "ChunkPipe",
    "ChunkPipeReader",
    "TensorChannel",
    "TensorChannelReader",
]
