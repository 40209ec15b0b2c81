"""ray_tpu_torch.ops — hand-written Hopper kernels and their plain
versions for the hot path."""

from ray_tpu_torch.ops.attention import (
    blockwise_attention,
    flash_attention,
    flash_attention_fwd,
    gqa_expand,
    mha_reference,
)

__all__ = [
    "mha_reference",
    "blockwise_attention",
    "flash_attention",
    "flash_attention_fwd",
    "gqa_expand",
]
