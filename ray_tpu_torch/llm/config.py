"""LLM configuration + tokenizer protocol (PyTorch port of
ray_tpu/llm/config.py).

The tokenizer is pluggable: anything with encode/decode works;
ByteTokenizer is the dependency-free default so the stack runs
hermetically in tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

from ray_tpu_torch.models.decoding import SamplingParams


class ByteTokenizer:
    """UTF-8 bytes as token ids (0-255); id 256 = EOS."""

    vocab_size = 257
    eos_token_id = 256

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")


@dataclasses.dataclass
class LLMConfig:
    """Model + generation + deployment settings (reference:
    ray.llm LLMConfig)."""

    model: Any = "tiny"  # preset name or TransformerConfig
    max_len: int = 512
    params_path: Optional[str] = None  # a params tree saved by train.save_state
    tokenizer: Any = None  # encode/decode object; default ByteTokenizer
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    seed: int = 0
    # slots of ContinuousLLMEngine's fixed-slot KV cache (the Serve
    # deployment settings of the JAX package come with the Serve port)
    cache_slots: int = 8

    def get_tokenizer(self):
        return self.tokenizer if self.tokenizer is not None else ByteTokenizer()
