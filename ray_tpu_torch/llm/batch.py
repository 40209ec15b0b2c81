"""LLM batch inference over ray_tpu_torch.data (PyTorch port of
ray_tpu/llm/batch.py; reference: python/ray/llm/_internal/batch/processor/
— vLLM engine processors).

``build_llm_processor(config)`` returns ``Dataset -> Dataset``: the
process lazily builds ONE engine (cached per config and device) and maps
prompt batches through it, block by block.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from ray_tpu_torch import default_device
from ray_tpu_torch.llm.config import LLMConfig
from ray_tpu_torch.models.decoding import SamplingParams

# one engine per (process, config identity, device) — rebuilding the
# engine per block would draw or load its weights every time
_ENGINE_CACHE: Dict[tuple, Any] = {}


def _engine_for(config: LLMConfig, device=None):
    # class name alone can't distinguish two HF tokenizers, so include
    # their vocab/name attributes too
    device = default_device(device)
    tok = config.get_tokenizer()
    key = (str(config.model), config.max_len, config.params_path,
           config.seed, type(tok).__name__,
           getattr(tok, "vocab_size", None),
           str(getattr(tok, "name_or_path", None)), str(device))
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        from ray_tpu_torch.llm.engine import LLMEngine

        eng = LLMEngine(config, device=device)
        _ENGINE_CACHE[key] = eng
    return eng


def build_llm_processor(
    config: LLMConfig,
    *,
    sampling: Optional[SamplingParams] = None,
    prompt_column: str = "prompt",
    output_column: str = "generated",
    batch_size: Optional[int] = None,
    device=None,
) -> Callable:
    """Returns ``process(ds) -> ds`` adding ``output_column`` with the
    completion for each row's ``prompt_column``. The engine runs on
    ``device`` (None: the card)."""
    device = default_device(device)

    def _infer(batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        eng = _engine_for(config, device)
        prompts = [str(p) for p in batch[prompt_column]]
        outs = eng.generate(prompts, sampling)
        return dict(batch, **{output_column: np.asarray(outs, object)})

    def process(ds):
        return ds.map_batches(_infer, batch_size=batch_size)

    return process
