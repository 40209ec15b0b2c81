"""ray_tpu_torch.ops — hand-written Hopper kernels and their plain
versions for the hot path."""

from ray_tpu_torch.ops.attention import (
    blockwise_attention,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    gqa_expand,
    mha_reference,
)
from ray_tpu_torch.ops.pipeline import pipelined_layers
from ray_tpu_torch.ops.ring_attention import ring_attention

__all__ = [
    "mha_reference",
    "blockwise_attention",
    "flash_attention",
    "flash_attention_fwd",
    "flash_attention_bwd",
    "gqa_expand",
    "ring_attention",
    "pipelined_layers",
]
