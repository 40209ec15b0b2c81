"""Model zoo of the PyTorch port (flagship: Llama-family decoder LM),
with its serving caches: slot-dense (``continuous_batching``) and paged
with prefix reuse (``paged_kv``), and disaggregated prefill over the
paged cache (``disagg_prefill``: KV rows from a prefill replica to a
decode replica through a tensor channel)."""

from ray_tpu_torch.models.disagg_prefill import (
    DecodeReplica,
    DisaggPrefillEngine,
    PrefillReplica,
)
from ray_tpu_torch.models.paged_kv import (
    KVPoolExhausted,
    PagedBatcher,
    PagedKV,
    prefix_keys,
)
from ray_tpu_torch.models.transformer import (
    PRESETS,
    TransformerConfig,
    config,
    forward,
    init_params,
    loss_fn,
    trainable_mask,
)

__all__ = [
    "DecodeReplica",
    "DisaggPrefillEngine",
    "PrefillReplica",
    "KVPoolExhausted",
    "PagedBatcher",
    "PagedKV",
    "prefix_keys",
    "PRESETS",
    "TransformerConfig",
    "config",
    "forward",
    "init_params",
    "loss_fn",
    "trainable_mask",
]
